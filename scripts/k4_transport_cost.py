#!/usr/bin/env python3
"""What K4's in-kernel transport costs on one card, and how K4's f32 form
compares with K2 on the same wgmma tile.

    python3 scripts/k4_transport_cost.py     # needs one CUDA card and nvcc

Builds a variant of ``mpi_knn_tpu_torch/csrc/fused_ring_dma.cu`` whose
transport copies nothing (the copy units still signal, so the barrier and
its waits run as usual) into the git-ignored build directory, then times,
by CUDA events and in turns (K4, K4 without the copy, K4), one K4 launch
at the main path's ring shapes: P=1 (60416 queries, a 61440-row block,
copied to the rank's other slot) and one P=4 round on one card (4 ranks of
15360 queries and 16384-row blocks). Beside them at P=1: K2 built with
8-deep promotion (K4's interval) on the same planes and norms. Each line
names the card and its power limit; the rows are ``make_mnist_like(60000)``
centered, as chip_smoke.py's.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the f32 form's copy units' copies (from the block's copy to the lo
# plane's), cut out of the variant
COPY = re.compile(r"    copy_part<false>\(R\.dst_blk, R\.blk, \(size_t\)p\.B \* p\.D \* "
                  r"sizeof\(float\).*?R\.dst_bl, R\.bl[^\n]*\n", re.S)


def build_without_copy(_build) -> ctypes.CDLL:
    src = (_build.CSRC / "fused_ring_dma.cu").read_text()
    src, cuts = COPY.subn("", src)
    if cuts != 1:
        raise SystemExit("fused_ring_dma.cu's copy units changed: update COPY")
    out = _build.BUILD_ROOT / "k4_without_copy"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "fused_ring_dma.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
                    str(out / "fused_ring_dma.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(out / "lib.so"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_transport_cost: needs a CUDA card", file=sys.stderr)
        return 2
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.backends import ring
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build, fused_knn, fused_rotation
    from mpi_knn_tpu_torch.ops.distance import center_for_l2
    from mpi_knn_tpu_torch.ops.topk import init_topk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {"k4": _build.load("fused_ring_dma"), "k4_without_copy": build_without_copy(_build)}
    k2lib = fused_knn.configure(_build.load("fused_knn", ("KNN_WGMMA_PROMOTE=1",)))
    load = _build.load

    def use(name):  # the wrappers on this build of fused_ring_dma.cu
        _build.load = lambda n, d=(): libs[name] if n == "fused_ring_dma" else load(n, d)
        fused_rotation._lib.cache_clear()
        fused_rotation._lib()

    def cuda_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    dev = torch.device("cuda", 0)
    X, _ = make_mnist_like(60000)
    Xc = center_for_l2(X, X, True)[0].astype(np.float32)
    cfg = KNNConfig(k=10, ring_fusion="fused")
    for shape, devs in (("p1", [dev]), ("p4_round", [dev] * 4)):
        _, c_tile, q_sh, qid_sh, travelers = ring.ring_shards(
            cfg, Xc, Xc, np.arange(60000, dtype=np.int32), devs)
        staged_q = [fused_rotation.stage_round_planes(q) for q in q_sh]
        blocks = [(b, i, s, n, hi, lo) for (b, i, s), (hi, lo, n) in zip(
            travelers[0], (fused_rotation.stage_round_planes(b) for b, _, _ in travelers[0]))]
        carries = [init_topk(q.shape[0], 10, device=dev) for q in q_sh]
        land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0) for b in blocks]
        transport = fused_rotation.ring_transport(devs)

        def k4():
            return fused_rotation.fused_round_dma(
                transport, q_sh, qid_sh, blocks, carries, land, c_tile=c_tile,
                query_norms=[t[2] for t in staged_q], query_planes=[t[:2] for t in staged_q])

        line = {"card": card, "shape": shape, "ranks": len(devs),
                "q_local": q_sh[0].shape[0], "b": blocks[0][0].shape[0]}
        for turn in ("k4", "k4_without_copy", "k4"):
            use(turn)
            line.setdefault(f"{turn}_ms", []).append(cuda_ms(k4))
        if shape == "p1":
            qh, ql, qn = staged_q[0]
            bn, bh, bl = blocks[0][3:]
            out_d = torch.empty((qh.shape[0], 10), device=dev)
            out_i = torch.empty((qh.shape[0], 10), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def k2():
                if k2lib.fused_knn_sweep_launch(
                        qh.data_ptr(), ql.data_ptr(), qn.data_ptr(), bh.data_ptr(),
                        bl.data_ptr(), bn.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                        qh.shape[0], bh.shape[0], qh.shape[1], 60000, 10, 1, 1, 1, 0.0,
                        stream):
                    raise RuntimeError("K2 launch failed")

            line["k2_8deep_same_planes_ms"] = [cuda_ms(k2), cuda_ms(k2)]
        print(json.dumps(line), flush=True)
        del q_sh, qid_sh, travelers, staged_q, blocks, carries, land
    _build.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
