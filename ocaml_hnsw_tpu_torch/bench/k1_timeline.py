"""Per-warp timeline of K1 (`csrc/payload_score.cu`) on one card.

    python -m ocaml_hnsw_tpu_torch.bench.k1_timeline [--tree DIR] [--out F]

DIR is a checkout of the repository (default: this one).  `k1_stamps.patch`
beside this script is a unified diff that puts `K1_STAMP(k)` calls into
DIR's `csrc/payload_score.cu`, k in [0, SLOTS):

    0        warp start               1   node ids loaded, first copies
    2 + 2i   item i landed (i < 6)        issued
    3 + 2i   item i scored (i < 6)    14  the warp's last item scored
    15       warp exit

The patch fits this checkout's kernel, so DIR's must take it too.  The
stamped source is compiled alone into a library of its own in a
temporary directory, with a header force-included that defines `K1_STAMP`
(lane 0 of the warp writes `%globaltimer`, and `%smid` at the start, to a
device buffer: little, since the kernel is held to 64 registers and a
heavier stamp made it spill); DIR's wrapper (`packed_score`) then launches
that library's kernel.  The shipped source is never changed.

For each shape (main B=4096, F3 bits=4, F4 refined deg 16) the report gives,
cold (a 128 MiB buffer read before the call) and warm (the call repeated),
the event time and, over the warps of the median-span run of five: the
start offset from the first warp's start, the time to the ids, to the first
stage (and its offset), each later item's wait for its stage, each item's
scoring, and the exit offset, as quantiles in ns; and the kernel's span
(first start to last exit), whose gap to the event time is launch and
drain.  The stamps cost the kernel time of their own: compare timelines
with each other, and take kernel times from `chip_smoke.py` or
`kernel_race.py`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SLOTS = 16
HERE = Path(__file__).resolve().parent
PATCH = HERE / "k1_stamps.patch"
N_NODES = 1_000_000
#: (label, B, E, deg, d_pad stored bytes, slots, bits)
SHAPES = (
    ("main B=4096", 4096, 2, 32, 128, 32, 8),
    ("F3 bits=4 B=4096", 4096, 2, 32, 64, 32, 4),
    ("F4 deg=16 B=4096", 4096, 2, 16, 128, 16, 8),
)

HEADER = r"""
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#define K1_TL_SLOTS %(slots)d
__device__ unsigned long long* k1_tl;  // [warps][K1_TL_SLOTS][2]
__device__ __forceinline__ void k1_stamp(int k) {
  unsigned long long g;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g));
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  unsigned long long* p = k1_tl + (w * K1_TL_SLOTS + k) * 2;
  p[0] = g;
  if (k == 0) {
    unsigned s;
    asm("mov.u32 %%0, %%%%smid;" : "=r"(s));
    p[1] = s;
  }
}
#define K1_STAMP(k)                                  \
  do {                                               \
    if ((threadIdx.x & 31) == 0 && k1_tl) k1_stamp(k); \
  } while (0)
extern "C" int ohnsw_k1_timeline(void* buf) {
  return (int)cudaMemcpyToSymbol(k1_tl, &buf, sizeof(buf));
}
""" % dict(slots=SLOTS)


def apply_patch(text: str, patch: str) -> str:
    """`text` with each hunk of the unified diff `patch` applied: a hunk's
    old lines (context and removed) must occur in `text` exactly once, and
    are replaced by its new lines (context and added)."""
    hunks = re.split(r"^@@[^\n]*\n", patch, flags=re.M)[1:]
    if not hunks:
        raise ValueError("k1_timeline: the patch has no hunk")
    for hunk in hunks:
        old, new = [], []
        for line in hunk.splitlines(keepends=True):
            tag, body = line[:1], line[1:]
            if tag in (" ", "-"):
                old.append(body)
            if tag in (" ", "+"):
                new.append(body)
        old_text = "".join(old)
        if text.count(old_text) != 1:
            raise ValueError("k1_timeline: a hunk does not fit the source "
                             f"once:\n{old_text}")
        text = text.replace(old_text, "".join(new))
    return text


def _quantiles(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {}
    pick = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa: E731
    return dict(p10=pick(0.1), p50=pick(0.5), p90=pick(0.9), max=xs[-1],
                n=len(xs))


def summarize(buf, n_items: int) -> dict:
    """Per-warp stamps [warps, SLOTS, 2] (int64 tensor on the CPU) -> the
    report's quantiles (module docstring)."""
    g = buf[:, :, 0]
    live = g[:, 0] > 0
    g, sm = g[live], buf[live][:, 0, 1]
    t0 = int(g[:, 0].min())
    warps = int(g.shape[0])
    per_sm = [int(v) for v in sm.bincount() if v]
    out = dict(warps=warps, sms=len(per_sm),
               warps_per_sm=statistics.median(per_sm),
               items_per_warp=n_items / warps,
               span_ns=int(g[:, SLOTS - 1].max()) - t0)
    start, ids, land, land_at, wait, score, tail, exit_ = (
        [] for _ in range(8))
    for r in g.tolist():
        start.append(r[0] - t0)
        exit_.append(r[SLOTS - 1] - t0)
        ids.append(r[1] - r[0])
        if r[2]:
            land.append(r[2] - r[1])
            land_at.append(r[2] - t0)
        prev = r[1]
        for i in range(6):
            landed, scored = r[2 + 2 * i], r[3 + 2 * i]
            if not (landed and scored):
                break
            if i:
                wait.append(landed - prev)
            score.append(scored - landed)
            prev = scored
        if r[14]:
            tail.append(r[SLOTS - 1] - r[14])
    out.update(start_ns=_quantiles(start), ids_ns=_quantiles(ids),
               first_landed_ns=_quantiles(land),
               first_landed_at_ns=_quantiles(land_at),
               later_wait_ns=_quantiles(wait), score_ns=_quantiles(score),
               last_item_to_exit_ns=_quantiles(tail),
               exit_at_ns=_quantiles(exit_))
    return out


def _stamped_library(_lib, patch: Path, tmp: Path):
    """The tree's payload_score.cu with `patch` applied, built alone with
    the stamp header into a library in `tmp`, loaded with the tree's
    signatures."""
    import ctypes

    src = _lib.CSRC / "payload_score.cu"
    stamped = tmp / "payload_score.cu"
    stamped.write_text(apply_patch(src.read_text(), patch.read_text()))
    hdr = tmp / "k1_timeline.cuh"
    hdr.write_text(HEADER)
    lib_path = tmp / "libk1_timeline.so"
    proc = subprocess.run(
        [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", f"-I{_lib.CSRC}",
         "-include", str(hdr), "-o", str(lib_path), str(stamped)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"k1_timeline: nvcc failed\n{proc.stdout}"
                         f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _lib._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.ohnsw_k1_timeline.argtypes = [ctypes.c_void_p]
    lib.ohnsw_k1_timeline.restype = ctypes.c_int
    return lib


def _check(k1, args, label: str) -> None:
    """The stamped kernel against the tree's plain version on `args`: ids
    equal, distances equal at bits=8 and within a loose 1e-4 of the largest
    at bits=4 (a guard against a broken stamp; chip_smoke.py holds the
    shipped kernel to the f32 summation bound)."""
    import torch

    ids, d = k1.packed_score(*args)
    ids_ref, d_ref = k1.packed_score_plain(*args)
    fin = torch.isfinite(d_ref)
    ok = torch.equal(ids, ids_ref) and torch.equal(torch.isfinite(d), fin)
    if ok and args[8] == 8:
        ok = torch.equal(d, d_ref)
    elif ok:
        ok = bool(((d - d_ref).abs()[fin] <= 1e-4 * d_ref[fin].abs().max())
                  .all())
    if not ok:
        raise AssertionError(f"k1_timeline: {label} differs from the plain "
                             "version")


def _worker(tree: str, out_path: str) -> None:
    """Runs in a child process with `tree` first on sys.path (its wrapper,
    its csrc); times with this checkout's `kernel_race.time_ms`."""
    sys.path.insert(0, tree)
    import torch

    from ocaml_hnsw_tpu_torch.ops.kernels import _lib
    from ocaml_hnsw_tpu_torch.ops.kernels import payload_score as k1

    spec = importlib.util.spec_from_file_location("_k1_race",
                                                  HERE / "kernel_race.py")
    race = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(race)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.zeros(race.FLUSH_BYTES // 4, device=dev)
    report = dict(card=smi, tree=tree, patch=PATCH.name, shapes=[])
    print(f"[timeline] {smi}; {tree} with {PATCH.name}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        _lib._lib = _stamped_library(_lib, PATCH, Path(tmp))
        # a row per warp the card can hold (at most 64 per SM)
        tl = torch.zeros((sms * 64, SLOTS, 2), dtype=torch.int64, device=dev)
        _lib.check(_lib._lib.ohnsw_k1_timeline(tl.data_ptr()), "timeline")
        g = torch.Generator(device=dev).manual_seed(7)
        for label, b, e, deg, d_pad, slots, bits in SHAPES:
            pay = torch.randint(-127, 128, (N_NODES, deg, d_pad),
                                dtype=torch.int8, device=dev, generator=g)
            meta = torch.cat([
                torch.randint(0, N_NODES, (N_NODES, deg), dtype=torch.int32,
                              device=dev, generator=g),
                torch.randint(0, 1 << 21, (N_NODES, deg), dtype=torch.int32,
                              device=dev, generator=g)], dim=1)
            nodes = torch.randint(0, N_NODES, (b, e), dtype=torch.int32,
                                  device=dev, generator=g)
            if bits == 8:
                q = torch.randint(-127, 128, (b, d_pad), dtype=torch.int8,
                                  device=dev, generator=g)
            else:
                q = (torch.randn((b, 2 * d_pad), device=dev, generator=g)
                     * 3).to(torch.bfloat16)
            qn = torch.rand(b, device=dev, generator=g) * 100
            scale = torch.tensor([0.02], device=dev)
            args = (nodes, meta, pay, q, qn, scale, True, slots, bits)
            _check(k1, args, label)
            row = dict(label=label, shape=[b, e, deg, d_pad], slots=slots,
                       bits=bits)
            for mode, cold in (("cold", "read"), ("warm", "warm")):
                runs = []
                for _ in range(5):
                    tl.zero_()
                    ms = race.time_ms(lambda: k1.packed_score(*args), cold,
                                      1, flush)
                    s = summarize(tl.cpu(), b * e)
                    s["event_us"] = ms * 1e3
                    runs.append(s)
                runs.sort(key=lambda s: s["span_ns"])
                row[f"timeline_{mode}"] = runs[len(runs) // 2]
            report["shapes"].append(row)
            print(f"[timeline] {json.dumps(row)}", flush=True)
            del pay, meta
        _lib.check(_lib._lib.ohnsw_k1_timeline(None), "timeline")
        _lib._lib = None
    Path(out_path).write_text(json.dumps(report, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(HERE.parents[1]),
                    help="a checkout of the repository (default: this one)")
    ap.add_argument("--out", default="k1_timeline.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    if args.worker:
        _worker(tree, args.out)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_timeline: no CUDA device available")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, __file__, "--tree", tree,
           "--out", str(Path(args.out).resolve()), "--worker"]
    proc = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=tree),
                          cwd=tree, timeout=1500)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
