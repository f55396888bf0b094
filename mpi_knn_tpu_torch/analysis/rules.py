"""Rules R1–R8 over a recorded eager run: the counterpart of the JAX
package's ``analysis/rules.py``.

Each JAX rule claims a property of the XLA program a configuration runs
and reads it off the compiled HLO. The port runs eagerly, so each rule
below claims the same property of the run that
:mod:`~mpi_knn_tpu_torch.analysis.lowering` recorded
(``utils/op_trace.py``: the aten ops with their storages, the kernels'
side-band records, the transport log, the live bytes):

- **R1-overlap** — comm/compute sequencing, from the transport log. Under
  ``ring-overlap`` each round's copies start before that round's first
  merge and are waited on only after its last (before the merge of the
  next round that consumes them); under ``ring`` every copy is issued
  after the round's merges. A round whose blocks a kernel moves itself
  (K4, K5) has no driver copy and must declare its side-band wire bytes,
  or the finding is "unpriced fused DMA". Achieved overlap is not a
  structural property: it stays the Kineto measurement
  (``obs/kineto.py`` ``stream_overlaps``), as the JAX package leaves it
  to ``obs/attribution``.
- **R2-memory** — no storage the run makes (an op's output, a kernel's
  output or scratch) is larger than max(largest input, 4·q_tile·c_tile,
  the registered extras) × accumulation bytes; clustered and mutation
  cells use the strict budget (the probe bound, per shard for
  ``ivf-sharded``; the touched working set) in place of the input floor,
  and quantized stores price the probe gather at code width.
- **R3-dtype** — in f64 cells no op narrows an f64 value; no product (an
  aten product or a kernel record) writes below f32; mixed cells have a
  compress pass (products of bf16-rounded operands, or a compress kernel),
  an exact rerank fed by it, and no compress over another's output;
  quantized cells have no product of raw int8 codes, and every compress
  pass reads exactly one dequantization (a code widening times its
  scale, or a compress kernel that takes the codes with their scales).
- **R4-collective** — the transport log's census: on a ring, each
  rotating round moves every rank's traveler parts (block and ids; the
  int8 wire's scales; K3a's norms where they ride along) to rank i+1
  (uni), or in counter-directed pairs i±1 (bidir), and a ring rotates
  P−1 times (uni) or ⌊P/2⌋ times each way (bidir); ``ivf-sharded``
  tiles run exactly the routed exchange's all-to-alls within its byte
  budget; single-device cells move nothing; nothing ever gathers or
  broadcasts through the process group in a cell.
- **R5-donation** — serve, ladder and front-end cells write a batch's
  results into the slot tensors made at warm-up; no op of a served batch
  or a mutation makes a storage as large as the resident store; a
  mutation (but a compaction) updates the store in place.
- **R6-ivf-probe** — every batched product of a clustered cell slices back
  to a gather from the bucket store; at least one exists; no un-batched
  product is wider than the centroid score.
- **R7-peak-memory** — the trace's live-bytes peak fits the JAX package's
  budget (the cell's inputs, its un-donated outputs and a 6× working
  set, with no largest-input floor), cross-checked on the CPU against
  the port's memory model (``analysis/memory.py``) where the cell has
  one, and on the card against the caching allocator's peak growth over
  the cell, within the band :data:`~mpi_knn_tpu_torch.analysis.memory.
  ALLOCATOR_BAND` states.
- **R8-cost** — the counted product FLOPs (on the CPU ``FlopCounterMode``
  over the plain versions; on the card the trace's own count of the ops
  outside the kernels plus the kernel side-band's logical FLOPs) equal
  ``analysis/cost.analytical_mxu_flops`` of the cell's facts exactly;
  HBM bytes from the trace and the side-band, link bytes from the
  transport log and the fused side-band, and the roofline under the
  profile of the device the cell ran on.

Parts of the JAX package's rules with no counterpart here, and why:

- the before-/after-optimization stages: eager PyTorch runs one program,
  so each rule checks the run once;
- ``buffer_donor`` / ``input_output_alias`` headers: no compiled module
  declares aliasing; R5 checks the writes into the slot tensors instead;
- the opt-barrier that sequences the blocking ring in HLO: the blocking
  ring's copies follow the merges in program order (R1 reads the order);
- ``collective-permute`` source-target pairs and replica groups: the
  port's transport log names each copy's source and destination rank;
- the PJRT memory cross-check: no runtime memory analysis exists for an
  eager run; the model (CPU) and the allocator (card) stand in;
- XLA's scan trip counts and computation multiplicities: an eager loop
  runs its trips, each recorded;
- SPMD partitioner annotations (R2's exemptions): nothing partitions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# findings and the rule protocol


@dataclass
class Finding:
    rule: str
    target: str
    stage: str
    message: str
    evidence: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"rule": self.rule, "target": self.target, "stage": self.stage,
                "message": self.message, "evidence": self.evidence}


class Rule:
    name = ""
    description = ""

    def applies(self, ctx) -> bool:
        return True

    def check(self, ctx, trace) -> list[Finding]:
        raise NotImplementedError

    def finding(self, ctx, message: str, **evidence) -> Finding:
        return Finding(self.name, ctx.target.label, ctx.stage, message,
                       evidence)


RULES: list[Rule] = []


def register(cls):
    RULES.append(cls())
    return cls


def rules_by_name(names=None) -> list[Rule]:
    if not names:
        return list(RULES)
    known = {r.name: r for r in RULES}
    missing = [n for n in names if n not in known]
    if missing:
        raise KeyError(f"unknown rule(s) {missing}; known: {sorted(known)}")
    return [known[n] for n in names]


# ---------------------------------------------------------------------------
# trace helpers

VIEW_NAMES = ("view", "reshape", "permute", "transpose", "t", "expand",
              "slice", "select", "unsqueeze", "squeeze", "alias",
              "_unsafe_view", "as_strided")
NARROW = ("float32", "bfloat16", "float16")
COPY_NAMES = ("clone", "_to_copy", "copy", "_copy_from", "contiguous")
INT_CODES = ("int8", "uint8")


def _op_base(op) -> str:
    return op.name.split(".")[1] if op.name.count(".") >= 1 else op.name


def source_op(trace, op, sid: int):
    """The op that made the value a storage holds when ``op`` reads it,
    looking through views and copies (None: an input of the call)."""
    seen = set()
    i = op.index
    while True:
        writer = None
        for j in trace.producers(i):
            if sid in trace.ops[j].writes:
                writer = trace.ops[j]
        if writer is None or writer.index in seen:
            return writer
        seen.add(writer.index)
        if writer.kind == "op" and writer.inputs and (
                _op_base(writer) in VIEW_NAMES or is_copy(writer)):
            sid, i = writer.inputs[0].sid, writer.index
            continue
        return writer


def is_rounding(op) -> bool:
    """A bf16 → f32 widening: the second half of ``bf16_round`` or a
    staged bf16 copy taken to f32 for a product."""
    return (op is not None and op.kind == "op" and "_to_copy" in op.name
            and op.inputs and op.inputs[0].dtype == "bfloat16"
            and op.outputs and op.outputs[0].dtype == "float32")


def is_dequant(trace, op) -> bool:
    """A dequantization: a product of a code widening and a scale."""
    if op is None or op.kind != "op" or _op_base(op) != "mul":
        return False
    return any(code_widening(source_op(trace, op, i.sid)) for i in op.inputs
               if i.sid >= 0)


def code_widening(op) -> bool:
    return (op is not None and op.kind == "op" and "_to_copy" in op.name
            and op.inputs and op.inputs[0].dtype in INT_CODES)


def product_operands(trace, op) -> list:
    """The ops that made each float operand of a product."""
    return [source_op(trace, op, i.sid) for i in op.inputs
            if i.sid >= 0 and i.dtype.startswith(("float", "bfloat"))]


def is_compress(trace, op) -> bool:
    """A compress pass: a product whose operands are all bf16-rounded, or a
    kernel of the bf16 compress form."""
    if op.kind == "kernel":
        return op.info.get("precision") == "bf16" and op.flops > 0
    srcs = product_operands(trace, op)
    return bool(srcs) and all(is_rounding(s) for s in srcs)


def is_copy(op) -> bool:
    """A plain copy (HLO's ``copy``): the same values at the same dtype in
    a new storage."""
    return (op.kind == "op" and _op_base(op) in COPY_NAMES and op.inputs
            and op.outputs and op.inputs[0].dtype == op.outputs[0].dtype)


def compress_ops(trace) -> list:
    return [o for o in trace.ops if (o.is_product or o.kind == "kernel")
            and is_compress(trace, o)]


# ---------------------------------------------------------------------------
# R1


@register
class R1Overlap(Rule):
    name = "R1-overlap"
    description = ("ring-overlap starts each round's copies before its merge "
                   "and waits only before the next round's; ring copies "
                   "after the merge; kernel-moved rounds declare wire bytes")

    def applies(self, ctx) -> bool:
        return "ring_n" in ctx.meta

    def check(self, ctx, trace) -> list[Finding]:
        out = []
        overlap = ctx.meta.get("overlap", True)
        for n, seg in enumerate(_rounds(trace)):
            head, body = seg[0], seg[1:]
            sends = [i for i, e in enumerate(body) if e["kind"] == "send"]
            merges = [i for i, e in enumerate(body) if e["kind"] == "merge"]
            waits = [i for i, e in enumerate(body) if e["kind"] == "wait"]
            if head["form"] != "driver":
                continue
            if not head["rotate"]:
                if sends or waits:
                    out.append(self.finding(
                        ctx, f"round {n} moves blocks but its schedule "
                        "rotates nothing"))
                continue
            if not sends or not merges:
                out.append(self.finding(
                    ctx, f"round {n}: a rotating round without "
                    f"{'copies' if not sends else 'a merge'}"))
                continue
            if overlap:
                if max(sends) > min(merges):
                    out.append(self.finding(
                        ctx, f"round {n}: a copy starts after the round's "
                        "first merge — the overlap schedule serializes the "
                        "transfer behind the compute", round=n))
                if waits and min(waits) < max(merges):
                    out.append(self.finding(
                        ctx, f"round {n}: the copy is waited on before the "
                        "round's merges finish — a blocking wait in the "
                        "overlap schedule", round=n))
            elif min(sends) < max(merges):
                out.append(self.finding(
                    ctx, f"round {n}: a copy starts before the round's last "
                    "merge — the blocking schedule must send after its "
                    "compute", round=n))
        for k in trace.kernels():
            if k.name.startswith(("fused_round_dma", "fused_rotation_grid")) \
                    and not k.info.get("wire_bytes"):
                out.append(self.finding(
                    ctx, f"{k.name} moves the ring's blocks in the kernel but "
                    "declares no wire bytes in its side-band record "
                    "(unpriced fused DMA)", op=k.index))
        return out


def _rounds(trace) -> list:
    """The transport log cut at each ring round."""
    segs = []
    for e in trace.transport:
        if e["kind"] == "round":
            segs.append([e])
        elif segs:
            segs[-1].append(e)
    return segs


# ---------------------------------------------------------------------------
# R2

R2_SLACK = 4


def r2_budget(meta: dict) -> tuple[int, str]:
    tile = meta["q_tile"] * meta["c_tile"]
    strict = meta.get("budget_elems")
    if strict is not None:
        elems = max(strict, R2_SLACK * tile)
        why = f"declared bound {strict} elems, not the resident store"
    else:
        elems = max(meta.get("input_elems", 0), R2_SLACK * tile,
                    meta.get("extra_elems", 0))
        why = (f"max(largest input {meta.get('input_elems', 0)} elems, "
               f"{R2_SLACK}×{meta['q_tile']}×{meta['c_tile']} tile elems)")
    return elems * meta["acc_bytes"], why


@register
class R2Memory(Rule):
    name = "R2-memory"
    description = ("no storage beyond the query_tile×corpus_tile budget (or "
                   "the largest input) — no accidental m×m materialization")

    def check(self, ctx, trace) -> list[Finding]:
        budget, why = r2_budget(ctx.meta)
        quant_gather = ctx.meta.get("quant_gather_bytes")
        out = []
        for op, nbytes in trace.allocations():
            if nbytes > budget:
                out.append(self.finding(
                    ctx, f"op {op.index} ({op.name}) materializes {nbytes} "
                    f"bytes > budget {budget} ({why} × "
                    f"{ctx.meta['acc_bytes']} acc bytes)",
                    op=op.index, bytes=nbytes, budget=budget))
            if (quant_gather is not None and op.kind == "op"
                    and _op_base(op) == "index" and nbytes > quant_gather):
                out.append(self.finding(
                    ctx, f"op {op.index} gathers {nbytes} bytes > the "
                    f"quantized wire budget {quant_gather} — dequantize after "
                    "the gather, not before", op=op.index, bytes=nbytes))
        return out


# ---------------------------------------------------------------------------
# R3


@register
class R3Dtype(Rule):
    name = "R3-dtype"
    description = ("no f64 narrowing in f64 cells; no product below f32; the "
                   "mixed compress/rerank and quant/dequant contracts")

    def check(self, ctx, trace) -> list[Finding]:
        out = []
        if ctx.target.dtype == "float64":
            for op in trace.ops:
                if (op.kind == "op" and op.inputs and op.outputs
                        and op.inputs[0].dtype == "float64"
                        and op.outputs[0].dtype in NARROW):
                    out.append(self.finding(
                        ctx, f"op {op.index} ({op.name}) narrows an f64 value "
                        f"to {op.outputs[0].dtype}", op=op.index))
        for op in trace.ops:
            if not (op.is_product or (op.kind == "kernel" and op.flops)):
                continue
            low = [o.dtype for o in op.outputs
                   if o.dtype in ("bfloat16", "float16")]
            if low:
                out.append(self.finding(
                    ctx, f"{op.name} (op {op.index}) writes its product as "
                    f"{low[0]}: the product must accumulate in f32 or wider",
                    op=op.index))
        compress = compress_ops(trace)
        if "w" in ctx.meta.get("cost", {}):
            out += self._mixed(ctx, trace, compress)
        if ctx.meta.get("quantized"):
            out += self._quant(ctx, trace, compress)
        return out

    def _mixed(self, ctx, trace, compress) -> list[Finding]:
        if not compress:
            return [self.finding(ctx, "a mixed cell with no compress pass "
                                 "(no product of bf16-rounded operands)")]
        cset = {o.index for o in compress}
        out = []
        for op in compress:
            if trace.backward_slice(op.index) & cset:
                out.append(self.finding(
                    ctx, f"compress pass op {op.index} reads another compress "
                    "pass's output — two compress passes in one computation",
                    op=op.index))
        reranks = [o for o in trace.products() if o.index not in cset
                   and trace.backward_slice(o.index) & cset]
        if not reranks:
            out.append(self.finding(
                ctx, "a mixed cell with no exact rerank fed by its compress "
                "pass"))
        return out

    def _quant(self, ctx, trace, compress) -> list[Finding]:
        out = []
        for op in trace.products():
            if any(i.dtype in INT_CODES for i in op.inputs) or any(
                    code_widening(s) for s in product_operands(trace, op)):
                out.append(self.finding(
                    ctx, f"product op {op.index} consumes raw int8 codes "
                    "(no scale applied)", op=op.index))
        dequants = [o for o in trace.ops if is_dequant(trace, o)]
        kernel_codes = [o for o in trace.kernels()
                        if any(i.dtype == "int8" for i in o.inputs)]
        if not dequants and not kernel_codes:
            out.append(self.finding(
                ctx, "a quantized cell with no dequantization: the codes "
                "never reach a product"))
        dset = {o.index for o in dequants}
        for op in compress:
            if op.kind == "kernel":
                codes = [i for i in op.inputs if i.dtype == "int8"]
                if codes and len(op.inputs) < 2:
                    out.append(self.finding(
                        ctx, f"{op.name} reads int8 codes without scales",
                        op=op.index))
                continue
            n = len(trace.backward_slice(op.index) & dset)
            if n != 1:
                out.append(self.finding(
                    ctx, f"compress pass op {op.index} is fed by {n} "
                    "dequantizations (exactly one, with its scale)",
                    op=op.index, dequantizations=n))
        return out


# ---------------------------------------------------------------------------
# R4


@register
class R4Collectives(Rule):
    name = "R4-collective"
    description = ("the ring moves exactly its traveler parts to i±1 each "
                   "round; sharded tiles run exactly the routed exchange; "
                   "single-device cells move nothing")

    def check(self, ctx, trace) -> list[Finding]:
        out = [self.finding(ctx, f"a process-group {e['op']} in a cell: no "
                            "store is ever gathered or broadcast",
                            event=e["op"])
               for e in trace.events("collective")]
        if "ring_n" in ctx.meta:
            out += self._ring(ctx, trace)
        elif "shards" in ctx.meta and not ctx.meta.get("mutate"):
            out += self._exchange(ctx, trace)
        elif trace.events("send", "exchange"):
            out.append(self.finding(
                ctx, f"{len(trace.events('send', 'exchange'))} transfers in "
                "a single-device cell"))
        return out

    def _ring(self, ctx, trace) -> list[Finding]:
        P = ctx.meta["ring_n"]
        parts = set(ctx.meta["expected_parts"])
        bidir = ctx.meta["ring_schedule"] == "bidir"
        shifts = (1, -1) if bidir else (1,)
        out, rotations = [], 0
        budget = ctx.meta.get("permute_bytes_budget")
        for n, seg in enumerate(_rounds(trace)):
            head = seg[0]
            sends = [e for e in seg if e["kind"] == "send"]
            if head["form"] != "driver" or not head["rotate"]:
                continue
            rotations += 1
            for shift in shifts:
                for r in range(P):
                    mine = [e for e in sends if e["src"] == r
                            and e["shift"] == shift]
                    got = {e["part"] for e in mine}
                    if got != parts or len(mine) != len(parts):
                        out.append(self.finding(
                            ctx, f"round {n}, rank {r}, direction {shift:+d}:"
                            f" moved {sorted(got)} ({len(mine)} copies), "
                            f"expected {sorted(parts)}", round=n, rank=r))
                    if any(e["dst"] != (r + shift) % P for e in mine):
                        out.append(self.finding(
                            ctx, f"round {n}: rank {r} sends off its "
                            f"ring neighbour {(r + shift) % P}", round=n))
            stray = [e for e in sends if e["shift"] not in shifts]
            if stray:
                out.append(self.finding(
                    ctx, f"round {n}: {len(stray)} copies in a direction the "
                    "schedule does not run"))
            if budget is not None:
                for e in sends:
                    if e["part"] == "block" and e["bytes"] > budget:
                        out.append(self.finding(
                            ctx, f"round {n}: a {e['bytes']}-byte block on "
                            f"the int8 wire (budget {budget})", round=n))
        dma = [k for k in trace.kernels()
               if k.name.startswith(("fused_round_dma", "fused_rotation_grid"))]
        want = P // 2 if bidir else P - 1
        if dma:
            if any(e for e in trace.events("send")):
                out.append(self.finding(
                    ctx, "driver copies beside a kernel that moves the blocks"))
        elif rotations != want:
            out.append(self.finding(
                ctx, f"{rotations} rotating rounds, expected {want} "
                f"({'bidir' if bidir else 'uni'} over {P} ranks): a rotation "
                "dropped or added", rotations=rotations, expected=want))
        return out

    def _exchange(self, ctx, trace) -> list[Finding]:
        events = trace.events("exchange")
        want = ctx.meta["expected_alltoalls"]
        budget = ctx.meta["exchange_bytes_tile"]
        tiles, cur = [], None
        for e in events:
            if e["part"] == "requests":
                cur = []
                tiles.append(cur)
            if cur is None:
                return [self.finding(ctx, "an exchange return with no "
                                     "request table before it")]
            cur.append(e)
        out = []
        if not tiles:
            out.append(self.finding(ctx, "a sharded cell with no candidate "
                                    "exchange"))
        for n, t in enumerate(tiles):
            if len(t) != want:
                out.append(self.finding(
                    ctx, f"tile {n}: {len(t)} all-to-alls, expected {want}",
                    tile=n))
            total = sum(e["bytes"] for e in t)
            if total > budget:
                out.append(self.finding(
                    ctx, f"tile {n}: the exchange moves {total} bytes > its "
                    f"budget {budget}", tile=n, bytes=total))
        return out


# ---------------------------------------------------------------------------
# R5


@register
class R5Donation(Rule):
    name = "R5-donation"
    description = ("served batches write into their slot's tensors; no "
                   "corpus-sized copy; mutation updates the store in place")

    def applies(self, ctx) -> bool:
        return bool(ctx.meta.get("serve") or ctx.meta.get("mutate"))

    def check(self, ctx, trace) -> list[Finding]:
        out = []
        meta = ctx.meta
        resident = meta["resident_bytes"]
        if meta.get("mutate") != "compact":
            for op, nbytes in trace.allocations():
                if is_copy(op) and nbytes >= resident:
                    out.append(self.finding(
                        ctx, f"op {op.index} ({op.name}) copies {nbytes} bytes "
                        f">= the resident store ({resident}): the call re-pays "
                        "the corpus", op=op.index, bytes=nbytes))
        # in place: into a storage that existed before the call (an
        # address the call freed and allocated again is another storage)
        written = {trace.storages[s]["key"] for o in trace.ops for s in o.writes
                   if not trace.storages[s]["made"]}
        if meta.get("serve"):
            if not set(meta["slot_keys"]) & written:
                out.append(self.finding(
                    ctx, "the batch's results were not written into its "
                    "slot's preallocated tensors (a fresh result allocation "
                    "a batch)"))
        elif meta.get("mutate") != "compact":
            if tuple(meta["store_after"]) != tuple(meta["store_before"]):
                out.append(self.finding(
                    ctx, "the mutation swapped the store for a new one "
                    "instead of updating it in place"))
            touched = [k for k in meta["store_before"] if k in written]
            if not touched:
                out.append(self.finding(
                    ctx, "the mutation wrote none of the resident store's "
                    "tensors in place"))
        return out


# ---------------------------------------------------------------------------
# R6


@register
class R6IvfProbe(Rule):
    name = "R6-ivf-probe"
    description = ("every batched product slices back to the probe gather of "
                   "the bucket store; no un-batched product wider than the "
                   "centroid score")

    def applies(self, ctx) -> bool:
        return "partitions" in ctx.meta and not ctx.meta.get("mutate")

    def check(self, ctx, trace) -> list[Finding]:
        store = set(ctx.meta["store_keys"])
        gathers = {o.index for o in trace.ops
                   if o.kind == "op" and _op_base(o) == "index"
                   and any(trace.storages[i.sid]["key"] in store
                           for i in o.inputs if i.sid >= 0)}
        out = []
        batched = [o for o in trace.products()
                   if o.base in ("aten.bmm", "aten.baddbmm")]
        if not batched:
            out.append(self.finding(ctx, "no batched candidate product: the "
                                    "probe contract is vacuous"))
        for op in batched:
            if not trace.backward_slice(op.index) & gathers:
                out.append(self.finding(
                    ctx, f"batched product op {op.index} does not read the "
                    "probe gather of the bucket store", op=op.index))
        width = ctx.meta["partitions"]
        for op in trace.products():
            if op.base in ("aten.mm", "aten.addmm") and op.outputs \
                    and op.outputs[0].shape[-1] > width:
                out.append(self.finding(
                    ctx, f"un-batched product op {op.index} is "
                    f"{op.outputs[0].shape[-1]} wide > the centroid score's "
                    f"{width}: an un-probed scan", op=op.index))
        return out


# ---------------------------------------------------------------------------
# R7 and R8: their bodies live beside the models they read


@register
class R7PeakMemory(Rule):
    name = "R7-peak-memory"
    description = ("the trace's live-bytes peak fits args + un-donated outputs "
                   "+ a 6× working set, and agrees with the model (CPU) or "
                   "the allocator (card)")

    def check(self, ctx, trace) -> list[Finding]:
        from mpi_knn_tpu_torch.analysis.memory import r7_check

        return [self.finding(ctx, msg, **ev) for msg, ev in r7_check(ctx, trace)]


@register
class R8Cost(Rule):
    name = "R8-cost"
    description = ("counted product FLOPs equal the closed form exactly; HBM "
                   "and link bytes and the roofline, banked in the ledger")

    def check(self, ctx, trace) -> list[Finding]:
        from mpi_knn_tpu_torch.analysis.cost import r8_check

        return [self.finding(ctx, msg, **ev) for msg, ev in r8_check(ctx, trace)]
