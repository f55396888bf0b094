"""Where the bin-minimum kernel's time goes, on a card: builds of
``mpi_knn_tpu_torch/csrc/approx_topk.cu`` with one part taken out, timed
beside the committed kernel at the five path shapes of the fused form
(``approx_smallest_k`` as ``smallest_k`` launches it; chip_smoke.py's
``FUSED_CASES``).

Variants, each the committed source with one text replaced (a variant
whose text is no longer in the source stops the tool by name):

  kernel                     the committed source
  no_selection               each lane's first key in place of the sort
                             and the rounds
  no_row_reads               keys from a hash of (row, lane, slot) in place
                             of the row's columns
  no_work                    the grid alone: the launch floor of its CTAs
  prefetch_8_floats_a_lane   one segment of loads in flight a lane
  prefetch_32_floats_a_lane  32 floats in flight a lane

and the committed kernel on two other launches of the same shapes:

  cta_plan                   a CTA a row of 512-bin warps (the cta plan
                             forced at every width)
  one_cta                    the first CTA's rows alone (the chain of
                             dependent steps one CTA takes)

Each build is launched directly with its plan, as ``approx_smallest_k``
launches the committed one, once untimed before each timing. The
committed kernel, the prefetch variants and the CTA plan are first held
bit for bit to the plain version. Each (variant, case) prints one JSON
line: the device microseconds of two turns, each a mean of 20 calls
queued behind a spin kernel (CUDA events; chip_smoke.py's
``queued_ms``).

    python3 tools/approx_ablations.py     # one card; ~1 min with the builds
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    FUSED_CASES,
    K,
    RECALL_TARGET,
    approx_rows,
    emit,
    nvidia_smi_line,
    queued_ms,
)
from mpi_knn_tpu_torch.ops import _build, approx_topk  # noqa: E402

VARIANTS = {
    "kernel": (),
    "no_selection": (("    sort_lane<4 * G>(m);\n"
                      "    long long kept = select_rounds<4 * G>(m, s, o, lane);",
                      "    long long kept = m[0];"),),
    "no_row_reads": (("  chunk_minima<G>(a, dr, bin0, bin_end, lane, m);\n"
                      "  const bool final",
                      "#pragma unroll\n  for (int i = 0; i < 4 * G; ++i)\n"
                      "    m[i] = ((long long)((unsigned)(row * 2654435761u + lane * 40503u"
                      " + i * 977u) >> 1) << 32) | (unsigned)(4 * lane + i);\n"
                      "  const bool final"),),
    "no_work": (("    warp_item<G>(a, item, lists, list_len, smem + warp * (128 * G), lane);",
                 "    ;"),),
    "prefetch_8_floats_a_lane": (("  constexpr int U = G >= 4 ? 1 : 4 / G;",
                                  "  constexpr int U = 1;"),),
    "prefetch_32_floats_a_lane": (("  constexpr int U = G >= 4 ? 1 : 4 / G;",
                                   "  constexpr int U = G >= 8 ? 1 : 8 / G;"),),
}
CHECKED = ("kernel", "prefetch_8_floats_a_lane", "prefetch_32_floats_a_lane",
           "cta_plan")


def build(tmp: str) -> dict:
    """{variant: its library, argument types bound}, the nvcc processes
    started together."""
    src = (_build.CSRC / "approx_topk.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"approx_ablations: variant {name}: its text "
                                 "is no longer in csrc/approx_topk.cu")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(tmp, f"lib{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"approx_ablations: nvcc failed on {name}\n{log}")
        libs[name] = approx_topk.bind(ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")))
    return libs


def cta_plan(rows, n, L, out) -> dict:
    """The cta plan at any width up to 8192 bins: a CTA a row of 512-bin
    warps, their lists merged by warp 0 (out <= 32)."""
    chunks = -(-L // 512)
    chunk = -(-(-(-L // chunks)) // 4) * 4
    return {**approx_topk.launch_plan(rows, n, L, out), "regime": "cta",
            "G": 4, "chunk": chunk, "chunks": chunks, "rows_per_cta": 1,
            "threads": 32 * chunks, "grid": rows,
            "shared_bytes": chunks * (512 + 32) * 8}


def launcher(lib, d, ids, method, plan_of):
    """A call that launches ``lib`` on the fused form's arguments of
    (d, ids, K, method) with the plan ``plan_of`` gives, and its outputs."""
    q, c = d.shape
    n_pad, L, out = approx_topk._fused_width(c, K, method, RECALL_TARGET)
    plan = plan_of(q, n_pad, L, out)
    assert plan["scratch_keys"] == 0, plan
    vals = torch.empty((q, out), dtype=torch.float32, device=d.device)
    out_ids = torch.empty((q, out), dtype=torch.int32, device=d.device)
    args = (d.data_ptr(), d.stride(0), q, c, n_pad, L, out,
            approx_topk.REGIMES.index(plan["regime"]), plan["G"],
            plan["chunk"], plan["chunks"], plan["shared_bytes"], None, 0,
            vals.data_ptr(), None, ids.data_ptr(),
            ids.stride(0) if ids.ndim == 2 else 0, out_ids.data_ptr(),
            torch.cuda.current_stream(d.device).cuda_stream)

    def call():
        err = lib.approx_min_k_launch(*args)
        if err:
            raise RuntimeError(f"approx_min_k_launch: CUDA error {err}, plan {plan}")

    return call, vals, out_ids


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("approx_ablations: torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    print(nvidia_smi_line(), flush=True)
    rng = np.random.default_rng(21)
    cases = []
    for case, rows, c, flat, method in FUSED_CASES[:5]:
        d = torch.from_numpy(approx_rows(rng, case, rows, c)).to(device)
        ids = torch.arange(c, dtype=torch.int32, device=device)
        cases.append((case, d, ids if flat else ids[None].repeat(rows, 1), method))
    tmp = tempfile.mkdtemp(prefix="approx_ablations_")
    try:
        libs = build(tmp)
        runs = {}
        for turn in range(2):
            for name in [*libs, "cta_plan", "one_cta"]:
                lib = libs.get(name, libs["kernel"])
                plan_of = cta_plan if name == "cta_plan" else approx_topk.launch_plan
                for case, d, ids, method in cases:
                    if name == "one_cta":
                        r = approx_topk.launch_plan(d.shape[0], *approx_topk._fused_width(
                            d.shape[1], K, method, RECALL_TARGET))["rows_per_cta"]
                        d, ids = d[:r], ids if ids.ndim == 1 else ids[:r]
                    call, vals, out_ids = launcher(lib, d, ids, method, plan_of)
                    call()  # the first launch of a build loads its module
                    torch.cuda.synchronize()
                    if turn == 0 and name in CHECKED:
                        wv, wi = approx_topk.approx_smallest_k_reference(d, ids, K, method)
                        if not (torch.equal(out_ids, wi) and torch.equal(
                                vals.view(torch.int32), wv.view(torch.int32))):
                            raise SystemExit(f"approx_ablations: {name}/{case} "
                                             "differs from the plain version")
                    runs.setdefault((name, case), []).append(queued_ms(call, 20) * 1e3)
        for (name, case), us in runs.items():
            emit({"phase": "approx_ablation", "variant": name, "case": case, "us": us})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
