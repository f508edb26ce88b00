"""Times the kernels of two checkouts of the port side by side on one card.

    python -m ocaml_hnsw_tpu_torch.bench.kernel_race --other DIR [--out F]

DIR is another checkout of the repository (e.g. a parent commit unpacked
with `git archive`).  Each checkout is timed in a process of its own, through
its own wrappers (`packed_score`, `gather_dists`, built from its own
`csrc/`), on identical inputs made on the device from fixed seeds, at the
main path's shapes: K1 at B = 4096 and 8192 (E = 2, deg = 32, d_pad = 128,
random nodes over a 1M-node payload), at phase C's B = 1024 E = 8, at phase
E's shard step (B = 8192 over a 100k-node payload), at phase F2's slots=16
(B = 8192), at bits=4 B = 4096 (64 stored bytes per row) and on phase F4's
refined deg-16 payload (B = 4096, [1M, 16, 128]), K2 f32 l2 at (8192, 32), (8192, 8) and (1024, 97) over
1M x 128 rows, K2 cosine at phase B's query and build blocks, (4096, 96) and
(2048, 96), over 96k x 768 unit f32 rows (laion-streaming's width), at
phase B8's, (4096, 96) and (1024, 96), over the same rows stored int8,
K2 int8 l2 at (8192, 32) over 1M x 96 rows (deep10m's width), and K3
(`scan_topk`) at the kNN table's block (8192 of the rows as queries, k =
97), the flat batch (8192 queries, k = 32) and the k = 256 batch (lists
of 256) over 1M x 128 bf16 rows, G1's int8 kNN block over the same rows
stored int8, D1's cosine flat batch (8192 queries, k = 32) over
1,183,514 x 100 bf16 rows (200-byte rows: the `cp.async` producer) and
D2's flat batch (8192 queries, k = 32) over 10M x 96 int8 rows; K3 only
with the L2 flushed by a read, `K3_REPS` reps.  The processes run in turns (other,
this, this, other) so that drift of the card shows; a result is the median
over both turns of each checkout.

Each process also keeps one call's output per case: the report says
whether the two checkouts' outputs are bit-equal (K3 over bf16 rows, if
not: whether its scores are within the f32 summation bound of the
other's, as two kernels that sum the product in other orders are;
`k3_within_bound`), and counts the
int->float conversion instructions (`I2F`, `I2FP`) in each checkout's
built kernels by `cuobjdump -sass`.

Each time is the median of CUDA-event timings of one call, with a spin
kernel holding the stream while the call is enqueued (so host launch cost is
not in it), under one of these L2 states:
  warm   the same call repeated: what the last call left in L2 is reused
  read   a 128 MiB buffer is read between reps (L2 holds only clean lines
         of it: the call finds its data cold)
  write  a 128 MiB buffer is written between reps (cold too, but the call
         pays for evicting ~50 MB of dirty lines)
and `enqueue` is one call timed without the spin kernel, so host launch
cost lands in the time, as the timings before this script did.  As a
yardstick of what the card's memory gives a plain stream, each process also
times `sum` over a 256 MiB buffer (read) and a 256 MiB `copy_` (read +
write), warm-up aside, with nothing flushed (256 MiB does not fit in L2).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

N_NODES, DEG, D_PAD = 1_000_000, 32, 128
N_ROWS, DIM = 1_000_000, 128
FLUSH_BYTES = 128 << 20
SPIN_CYCLES = 2_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
#: K1 at deg 32, d_pad 128: (label, B, E, payload nodes, slots)
K1_SHAPES = (("", 4096, 2, N_NODES, None), ("", 8192, 2, N_NODES, None),
             (" C", 1024, 8, N_NODES, None),
             (" E shard", 8192, 2, 100_000, None),
             (" slots=16", 8192, 2, N_NODES, 16))
K2_SHAPES = ((8192, 32), (8192, 8), (1024, 97))
WIDE_ROWS, WIDE_DIM = 96_000, 768
K2_WIDE_SHAPES = ((4096, 96), (2048, 96))
K2_INT8_WIDE_SHAPES = ((4096, 96), (1024, 96))
INT8_ROWS, INT8_DIM, K2_INT8_SHAPE = 1_000_000, 96, (8192, 32)
K1_INT4_B = 4096
K1_DEG16_B, DEG16 = 4096, 16
#: K3: (label, queries, k, scan dtype, rows, D, metric); main's shapes,
#: G1's, D1's, D2's
K3_CASES = (("kNN block", 8192, 97, "bf16", N_ROWS, DIM, "l2"),
            ("flat batch", 8192, 32, "bf16", N_ROWS, DIM, "l2"),
            ("k=256 batch", 8192, 256, "bf16", N_ROWS, DIM, "l2"),
            ("int8 kNN block", 8192, 97, "int8", N_ROWS, DIM, "l2"),
            ("flat batch D1", 8192, 32, "bf16", 1_183_514, 100, "cosine"),
            ("int8 flat batch D2", 8192, 32, "int8", 10_002_432, 96, "l2"))
K3_REPS = 5
MODES = ("warm", "read", "write", "enqueue")
THIS = Path(__file__).resolve().parents[2]
#: the conversion instructions `sass_op_counts` counts
CONVERSIONS = ("I2F", "I2FP")
_SASS_FN = re.compile(r"^\s*Function : (\S+)")
_SASS_OP = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def count_sass_ops(sass: str, ops=CONVERSIONS) -> dict[str, dict]:
    """{mangled kernel: {op: count}} over `cuobjdump -sass` text: each
    instruction line's opcode (its predicate and modifiers aside)."""
    counts: dict[str, dict] = {}
    fn = None
    for line in sass.splitlines():
        m = _SASS_FN.match(line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
            continue
        m = _SASS_OP.match(line)
        if fn is not None and m and m.group(1) in ops:
            counts[fn][m.group(1)] += 1
    return counts


def sass_op_counts(library: Path, ops=CONVERSIONS) -> dict[str, dict]:
    """`count_sass_ops` over a built kernel library (`cuobjdump -sass`,
    from the toolkit beside nvcc), with each kernel's registers under
    "REG" (`cuobjdump -res-usage`); kernel names demangled without their
    argument lists."""
    from ocaml_hnsw_tpu_torch.ops.kernels import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"

    def dump(flag: str) -> str:
        return subprocess.run([str(tool), flag, str(library)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout

    counts = count_sass_ops(dump("-sass"), ops)
    fn = None
    for line in dump("-res-usage").splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"\bREG:(\d+)", line)
        if m and fn in counts:
            counts[fn]["REG"] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(counts),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    return {name.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]: c
            for name, c in zip(names, counts.values())}


def time_ms(fn, mode: str, reps: int, flush) -> float:
    """Median over `reps` of the CUDA-event time of one call of `fn` (ms),
    after three unmeasured calls, under `mode` (module docstring); `flush`
    is the FLUSH_BYTES buffer the cold modes read or write."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if mode == "read":
            flush.sum()
        elif mode == "write":
            flush.zero_()
        if mode != "enqueue":
            torch.cuda._sleep(SPIN_CYCLES)
        else:
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _worker(tree: str, reps: int, dump: str) -> None:
    """Runs in a child process with `tree` first on sys.path; prints the
    timings as JSON and saves one output per case to `dump`."""
    sys.path.insert(0, tree)
    import torch

    from ocaml_hnsw_tpu_torch.ops.kernels import _lib
    from ocaml_hnsw_tpu_torch.ops.kernels.gather_dist import gather_dists
    from ocaml_hnsw_tpu_torch.ops.kernels.payload_score import packed_score
    from ocaml_hnsw_tpu_torch.ops.quantize import quantize_rows

    dev = torch.device("cuda")
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    g = torch.Generator(device=dev).manual_seed(2024)
    out, outputs = [], {}

    def case(kernel: str, shape, nbytes: int, fn, modes=MODES,
             n_reps=None, extra=()) -> None:
        """Times fn under `modes` and keeps one of its outputs (with
        `extra` tensors beside it)."""
        got = fn()
        outputs[f"{kernel} {list(shape)}"] = (
            tuple(got) if isinstance(got, tuple) else (got,)) + tuple(extra)
        for mode in modes:
            out.append(dict(kernel=kernel, shape=list(shape), mode=mode,
                            bytes=nbytes,
                            ms=time_ms(fn, mode, n_reps or reps, flush)))

    big = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(big)
    for name, fn, moved in (
            ("stream read (sum)", lambda: big.view(torch.float32).sum(), 1),
            ("stream copy", lambda: dst.copy_(big), 2)):
        out.append(dict(kernel=name, shape=[big.numel()], mode="warm",
                        bytes=moved * big.numel(),
                        ms=time_ms(fn, "warm", reps, flush)))
    del big, dst
    pay = torch.randint(-127, 128, (N_NODES, DEG, D_PAD), dtype=torch.int8,
                        device=dev, generator=g)
    ids = torch.randint(0, N_NODES, (N_NODES, DEG), dtype=torch.int32,
                        device=dev, generator=g)
    norms = torch.randint(0, 1 << 21, (N_NODES, DEG), dtype=torch.int32,
                          device=dev, generator=g)
    meta = torch.cat([ids, norms], dim=1)
    del ids, norms
    scale = torch.tensor([0.02], device=dev)
    for label, b, e, n, slots in K1_SHAPES:
        nodes = torch.randint(0, n, (b, e), dtype=torch.int32, device=dev,
                              generator=g)
        q8 = torch.randint(-127, 128, (b, D_PAD), dtype=torch.int8,
                           device=dev, generator=g)
        qn = torch.rand(b, device=dev, generator=g) * 100
        args = (nodes, meta[:n], pay[:n], q8, qn, scale, True, slots)
        k = slots or DEG
        nbytes = (int(torch.unique(nodes).numel()) * (k * D_PAD + 8 * k)
                  + b * (D_PAD + 4) + b * e * 4 + b * e * k * 8)
        case(f"packed_score{label}", [b, e, DEG, D_PAD], nbytes,
             lambda: packed_score(*args))
    # bits=4: the first half of each slab row's bytes as nibble pairs, a
    # bf16 query row of 2 x 64 components
    stored = D_PAD // 2
    pay4 = pay[:, :, :stored].contiguous()
    del pay
    b = K1_INT4_B
    nodes = torch.randint(0, N_NODES, (b, 2), dtype=torch.int32, device=dev,
                          generator=g)
    q16 = (torch.randn((b, 2 * stored), device=dev, generator=g) * 3).to(
        torch.bfloat16)
    qn = torch.rand(b, device=dev, generator=g) * 100
    args4 = (nodes, meta, pay4, q16, qn, scale, True, None, 4)
    nbytes = (int(torch.unique(nodes).numel()) * (DEG * stored + 8 * DEG)
              + b * (4 * stored + 4) + b * 2 * 4 + b * 2 * DEG * 8)
    case("packed_score bits=4", [b, 2, DEG, stored], nbytes,
         lambda: packed_score(*args4))
    del pay4, meta
    # the refined half-degree payload: deg 16, its own meta row
    pay16 = torch.randint(-127, 128, (N_NODES, DEG16, D_PAD),
                          dtype=torch.int8, device=dev, generator=g)
    meta16 = torch.cat([
        torch.randint(0, N_NODES, (N_NODES, DEG16), dtype=torch.int32,
                      device=dev, generator=g),
        torch.randint(0, 1 << 21, (N_NODES, DEG16), dtype=torch.int32,
                      device=dev, generator=g)], dim=1)
    b = K1_DEG16_B
    nodes = torch.randint(0, N_NODES, (b, 2), dtype=torch.int32, device=dev,
                          generator=g)
    q8 = torch.randint(-127, 128, (b, D_PAD), dtype=torch.int8, device=dev,
                       generator=g)
    qn = torch.rand(b, device=dev, generator=g) * 100
    args16 = (nodes, meta16, pay16, q8, qn, scale, True)
    nbytes = (int(torch.unique(nodes).numel()) * (DEG16 * D_PAD + 8 * DEG16)
              + b * (D_PAD + 4) + b * 2 * 4 + b * 2 * DEG16 * 8)
    case("packed_score deg=16", [b, 2, DEG16, D_PAD], nbytes,
         lambda: packed_score(*args16))
    del pay16, meta16
    rows = torch.randn((N_ROWS, DIM), device=dev, generator=g)
    ones = torch.ones(N_ROWS, device=dev)
    for b, k in K2_SHAPES:
        ids = torch.randint(0, N_ROWS, (b, k), dtype=torch.int32, device=dev,
                            generator=g)
        q = torch.randn((b, DIM), device=dev, generator=g)
        nbytes = (int(torch.unique(ids).numel()) * DIM * 4 + b * DIM * 4
                  + b * k * 8)
        case("gather_dists", [b, k, DIM], nbytes,
             lambda: gather_dists(rows, ones, q, ids, "l2"))
    del rows, ones
    rows = torch.randn((INT8_ROWS, INT8_DIM), device=dev, generator=g)
    vec, sc, _ = quantize_rows(rows, "int8")
    del rows
    b, k = K2_INT8_SHAPE
    ids = torch.randint(0, INT8_ROWS, (b, k), dtype=torch.int32, device=dev,
                        generator=g)
    q = torch.randn((b, INT8_DIM), device=dev, generator=g)
    nbytes = (int(torch.unique(ids).numel()) * (INT8_DIM + 4)
              + b * INT8_DIM * 4 + b * k * 8)
    case("gather_dists int8", [b, k, INT8_DIM], nbytes,
         lambda: gather_dists(vec, sc, q, ids, "l2"))
    del vec, sc
    rows = torch.randn((WIDE_ROWS, WIDE_DIM), device=dev, generator=g)
    rows /= torch.linalg.norm(rows, dim=1, keepdim=True)
    ones = torch.ones(WIDE_ROWS, device=dev)
    vec8, sc8, _ = quantize_rows(rows, "int8")
    for storage, vec, sc, shapes, row_bytes in (
            ("", rows, ones, K2_WIDE_SHAPES, WIDE_DIM * 4),
            (" int8", vec8, sc8, K2_INT8_WIDE_SHAPES, WIDE_DIM + 4)):
        for b, k in shapes:
            ids = torch.randint(0, WIDE_ROWS, (b, k), dtype=torch.int32,
                                device=dev, generator=g)
            q = torch.randn((b, WIDE_DIM), device=dev, generator=g)
            q /= torch.linalg.norm(q, dim=1, keepdim=True)
            nbytes = (int(torch.unique(ids).numel()) * row_bytes
                      + b * WIDE_DIM * 4 + b * k * 8)
            case(f"gather_dists{storage} cosine", [b, k, WIDE_DIM], nbytes,
                 lambda: gather_dists(vec, sc, q, ids, "cosine"))
    k3_cases(case, dev, g)
    torch.save({key: tuple(t.cpu() for t in o)
                for key, o in outputs.items()}, dump)
    out.append(dict(kernel="sass", counts=sass_op_counts(_lib.build())))
    print(json.dumps(out))


def k3_cases(case, dev, g) -> None:
    """K3 at K3_CASES: the rows and queries from `g`, the flat made by the
    checkout's own `flat_from_rows`; its bytes as chip_smoke counts them.
    A bf16 case keeps, beside its (scores, ids), each query's f32
    summation bound (`k3_within_bound`)."""
    import torch

    from ocaml_hnsw_tpu_torch.models import bulk as bulk_mod
    from ocaml_hnsw_tpu_torch.ops.kernels.scan_topk import scan_topk

    flats = {}
    for label, b, k, dtype, n, d, metric in K3_CASES:
        if (dtype, n, d, metric) not in flats:
            flats.clear()
            rows = torch.randn((n, d), device=dev, generator=g)
            flats[(dtype, n, d, metric)] = (
                rows[:b].clone(),
                bulk_mod.flat_from_rows(rows, metric, scan_dtype=dtype))
            del rows
        base, flat = flats[(dtype, n, d, metric)]
        q = base if "kNN" in label else torch.randn((b, d), device=dev,
                                                    generator=g)
        if metric == "cosine":
            q = q / torch.linalg.norm(q, dim=1, keepdim=True)
        args = (flat.scan, flat.scales, flat.norms, flat.deleted, flat.n, q)
        row = d * flat.scan.element_size() + 5 + (4 if dtype == "int8" else 0)
        extra = ()
        if dtype == "bf16":
            # 2 (l2) x 2 D 2^-24 x sum |q_i x_i| <= |q| max|x| (bf16 values)
            xmax = torch.linalg.norm(flat.scan.float(), dim=1).max()
            qn = torch.linalg.norm(q.to(torch.bfloat16).float(), dim=1)
            extra = (4 * d * 2.0 ** -24 * qn * xmax,)
        case(f"scan_topk {label}", [b, n, d, k], n * row + b * d * 4
             + b * k * 12, lambda: scan_topk(*args, k, metric),
             modes=("read",), n_reps=K3_REPS, extra=extra)
    flats.clear()


def k3_within_bound(a, b) -> bool:
    """Two K3 outputs (scores, ids, per-query bound) over bf16 rows: every
    finite score within the bound (plus the epilogue's last rounding) of
    the other's at the same slot, the same slots finite, and at least
    99.9% of the (query, slot) ids shared."""
    import torch

    fin = torch.isfinite(a[0])
    if not torch.equal(fin, torch.isfinite(b[0])):
        return False
    tol = a[2][:, None] + 2.0 ** -22 * b[0].abs()
    if ((a[0] - b[0]).abs() > tol)[fin].any():
        return False
    shared = (a[1][:, :, None] == b[1][:, None, :]).any(-1) & fin
    return float(shared.sum()) >= 0.999 * float(fin.sum())


def _compare(dumps: dict[str, list[str]]) -> dict[str, str]:
    """Per case: are the first turn's outputs of both checkouts bit-equal
    (K3 over bf16 rows, if not: within its f32 bound, `k3_within_bound`),
    and each checkout's two turns equal to each other?  A verdict per
    case: "bit-equal", "within the f32 bound" or "DIFFER"."""
    import torch

    got = {who: [torch.load(f) for f in files] for who, files in dumps.items()}
    same = {}
    for key in got["this"][0]:
        a, b = got["this"][0][key], got["other"][0][key]
        if key.startswith("scan_topk") and len(a) == 3:
            same[key] = ("bit-equal" if all(
                torch.equal(x, y) for x, y in zip(a[:2], b[:2])) else
                "within the f32 bound" if k3_within_bound(a, b) else "DIFFER")
            continue
        same[key] = "bit-equal" if all(
            torch.equal(x, y) for x, y in zip(a, b)) else "DIFFER"
        for who in got:
            if not all(torch.equal(x, y) for x, y in
                       zip(got[who][0][key], got[who][1][key])):
                raise SystemExit(f"kernel_race: {who}'s two turns disagree "
                                 f"on {key}")
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.worker, args.reps, args.dump)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_race: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    other = str(Path(args.other).resolve())
    turns = [("other", other), ("this", str(THIS)), ("this", str(THIS)),
             ("other", other)]
    results: dict[tuple, dict[str, list[float]]] = {}
    sass: dict[str, dict] = {}
    dumps: dict[str, list[str]] = {"this": [], "other": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (who, tree) in enumerate(turns):
            env = dict(os.environ, PYTHONPATH=tree)
            dump = os.path.join(tmp, f"{i}_{who}.pt")
            proc = subprocess.run(
                [sys.executable, __file__, "--other", other, "--worker",
                 tree, "--reps", str(args.reps), "--dump", dump],
                capture_output=True, text=True, env=env, cwd=tree,
                timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"kernel_race: {who} ({tree}) failed:\n"
                                 f"{proc.stdout[-4000:]}\n"
                                 f"{proc.stderr[-4000:]}")
            dumps[who].append(dump)
            for r in json.loads(proc.stdout.strip().splitlines()[-1]):
                if r["kernel"] == "sass":
                    sass[who] = r["counts"]
                    continue
                key = (r["kernel"], tuple(r["shape"]), r["mode"], r["bytes"])
                results.setdefault(key, {}).setdefault(who, []).append(
                    r["ms"])
        same = _compare(dumps)
    table = []
    print(f"[race] {smi}; other = {other}")
    for (kernel, shape, mode, nbytes), by in results.items():
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(kernel=kernel, shape=list(shape), mode=mode, bytes=nbytes,
                   bound_ms=bound_ms, card=smi,
                   other_ms=statistics.median(by["other"]),
                   this_ms=statistics.median(by["this"]),
                   other_turns=by["other"], this_turns=by["this"])
        if f"{kernel} {list(shape)}" in same:
            row["outputs"] = same[f"{kernel} {list(shape)}"]
        table.append(row)
        print(f"[race] {kernel} {list(shape)} {mode:7s} bound "
              f"{bound_ms * 1e3:6.1f} us  other {row['other_ms'] * 1e3:7.1f} us"
              f" ({bound_ms / row['other_ms']:.0%})  this "
              f"{row['this_ms'] * 1e3:7.1f} us ({bound_ms / row['this_ms']:.0%})"
              f"  turns other {[round(t * 1e3, 1) for t in by['other']]} "
              f"this {[round(t * 1e3, 1) for t in by['this']]}")
    for key, verdict in same.items():
        print(f"[race] outputs {key}: {verdict} between the checkouts")
    for who, counts in sass.items():
        for kernel, c in counts.items():
            print(f"[race] sass {who} {kernel}: {json.dumps(c)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=smi, rows=table, outputs=same, sass=sass), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
