#!/usr/bin/env python3
"""Questions about the split scoring kernels that ``chip_smoke.py`` does not
ask in every run, measured on one CUDA card.

    python3 tools/split_probe.py [--against DIR]
    python3 tools/split_probe.py --tune

Run from a checkout of the repository. Without ``--tune`` it

1. times ``chunk_dedup_kernel`` at the pruned path's chunk shape (indir
   [32, 1, 32], uniq [1024, 8], acc [32, 1, 8, 32]; random rows and
   indices, nine masks in ten set, seed 0) with the geometry's 256 / Wt =
   32 term slices and with 16 and 8: each slice count a copy of the kernel
   source whose slice count is capped at compile time, built by nvcc, and
   launched at cluster sizes 1 and 2;
2. tiles the same inputs along the term axis to L = 1, 32 and 320 and
   times the three split chunk kernels (``cobs_chunk_dedup``,
   ``cobs_chunk_lookup`` with uniq as the arena, ``cobs_chunk_lookup_comp``
   with uniq as the dictionary and identity refs) beside ``dedup_kernel``
   (``cobs_dedup_score``, the split body without running counts): each
   kernel's cost a launch and a term;
3. times ``chunk_lookup_comp_kernel`` at the rowdict store's tallest
   shard (idx [128, 1, 32], acc [128, 1, 8, 32], dict [16384, 4], refs
   [3,649,024]; random, seed 0) with the word tile cut from the running
   counts' Wp = 8 words (this source: half of a block's threads hold
   padding words and count nothing) and from the dictionary's W = 4 words
   (a copy of the source whose accumulate-mode tiles are cut from W, with
   64 slices, the last tile's threads also carrying the padding words'
   acc into out), in the order this, copy, copy, this, three times over;
4. times ``unpack_kernel`` at rows [320, 64], [64, 64] and two shapes
   where it picks a cluster, [1000, 8] and [4096, 1] (random rows, seed
   0), with 8 warps a word and with 4 and 16 (copies of the kernel
   source with ``kUnpackWarps`` changed, built by nvcc), at cluster sizes
   1, 2 and the entry point's choice, beside ``vertical_kernel`` at the
   same rows and, with ``--against``, the other checkout's
   ``cobs_unpack``;
5. with ``--against DIR``, a checkout of another commit whose split and
   gather entry points take the same arguments: builds that checkout's
   kernel source beside this one, says whether the SASS of the six older
   split kernels (``vertical_kernel``, ``lookup_kernel``,
   ``lookup_comp_kernel``, ``chunk_lookup_kernel``,
   ``chunk_lookup_comp_kernel``, ``chunk_dedup_kernel``) and of
   ``unpack_kernel`` is the same in both (with each one's ptxas report),
   and times both libraries' entry points at the main path's shapes
   (random rows and indices, arenas of the main index's height) in the
   order this, other, other, this, three times over: rows 1-5, 7 and 9-11
   of PERF.md's kernel table, rows 12-13 (the two chunk lookups, whose
   entry points took a counter-plane count where they now take a cluster
   size), rows 6 and 8 (the two gathers) and the dense read batch's dedup
   pair (``cobs_gather_rows`` then ``cobs_dedup_score``, one library's
   pair at a time) beside this library's fused lookup of the same batch;
6. times rows 6 and 8 and the dedup pair (random, seed 0) with a gather
   block's warps taking 1, 2, 4 and 8 warp-steps each (copies of the
   kernel source with ``kGatherSteps`` changed: fewer, busier warps a
   block), in the order 1, 2, 4, 8, 8, 4, 2, 1, three times over;
7. times the same with the gather releasing the dependent launch after
   its first row loads (this source) and as it starts (a copy), in the
   order this, copy, copy, this, three times over.

Every launch is first checked equal to its plain PyTorch version. Times
are the median of 5 replays of a CUDA graph of 64 launches, per launch.

With ``--tune`` it asks only the kernel tuner's questions, at the
geometry of ``chip_smoke.py``'s dense index (3,813,888 rows of W = 32
words, one hash, two blocks) and its read batch shape (L 128, Q 32):
three rounds of two fresh tunes at the default fixture cap (2,048 rows,
256 KB) and one with 2^20 fixture rows (128 MB, past the card's 50 MB
L2). Each tune prints its dedup threshold, every method's cost, the
cheapest method, and the measurements the break-even fit was made from
(each ``_measure_*`` call's time in us, a dedup call's padded unique
rows beside it).

Prints the card's name and power limit and writes the numbers to
``chiprun_out/split_probe.json`` (``tune_probe.json`` with ``--tune``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT_DIR = ROOT / "chiprun_out"
PROBE_DIR = ROOT / "build" / "probe"
SOURCE_REL = Path("src/repro_torch/kernels/csrc/bitslice_score.cu")
# the slice count of a split block, as split_body computes it
SLICE_LINE = "  const int wt = g.wt, S = g.slices;\n"
SLICES = (32, 16, 8)
CHUNK_LENGTHS = (1, 32, 320)
# the accumulate mode's word tile: cut from the running counts' Wp words
# (this source) or, in a copy, from the rows' W words, the last tile of a
# cell also carrying acc's padding words [W, Wp) into out
WCUT_LINES = (
    ("  const int Wo = kAcc ? Wp : W;\n"
     "  const SplitGeometry g = split_geometry(Wo);\n",
     "  const int Wo = kAcc ? Wp : W;\n"
     "  const SplitGeometry g = split_geometry(W);\n"),
    ("  const int wn = Wo - w0 < wt ? Wo - w0 : wt;   // the tile's words\n",
     "  const int wn = W - w0 < wt ? W - w0 : wt;   // the tile's words\n"),
    ("  const int wc = kAcc && W - w0 < wn ? W - w0 : wn;\n",
     "  const int wc = wn;\n"
     "  if (kAcc && w0 + wn == W) {\n"
     "    for (int e = W * 32 + t; e < Wp * 32; e += kSplitThreads) {\n"
     "      out[cell * Wp * 32 + e] = acc[cell * Wp * 32 + e];\n"
     "    }\n"
     "  }\n"),
)
# row 13 of PERF.md's kernel table: (cells shape, L, W, Wp, dict rows, refs)
ROW13 = ((128, 1), 32, 4, 8, 16_384, 3_649_024)
# the warps of an unpack block
WARPS_LINE = ("constexpr int kUnpackWarps = 8;  // warps (term slices) of an "
              "unpack block\n")
WARPS = (8, 4, 16)
UNPACK_SHAPES = (("row 1 rows [320, 64]", 320, 64),
                 ("row 1a rows [64, 64]", 64, 64),
                 ("rows [1000, 8]", 1000, 8), ("rows [4096, 1]", 4096, 1))
# (what, kernel, cells shape, L, W, arena rows) at the main path's shapes;
# lookup_comp's arena rows are refs entries over a dictionary of 4,096
MAIN_SHAPES = (
    ("row 2 vertical rows [320, 64]", "vertical", (1,), 320, 64, 0),
    ("row 3 lookup idx [2, 320]", "lookup", (2,), 320, 32, 3_813_888),
    ("row 4 lookup idx [32, 2, 320]", "lookup", (32, 2), 320, 32, 3_813_888),
    ("row 5 lookup idx [320]", "lookup", (), 320, 8, 3_649_024),
    ("row 9 lookup_comp idx [32, 1, 320]", "lookup_comp", (32, 1), 320, 4,
     88_064),
    ("row 10 lookup_comp idx [1, 320]", "lookup_comp", (1,), 320, 4,
     88_064),
    ("row 11 chunk_dedup indir [32, 1, 32]", "chunk_dedup", (32, 1), 32, 8,
     1024),
    ("row 1 unpack rows [320, 64]", "unpack", (1,), 320, 64, 0),
    ("row 7 dedup indir [32, 2, 128]", "dedup_score", (32, 2), 128, 32, 2048),
    ("row 12 chunk_lookup idx [128, 2, 32]", "chunk_lookup", (128, 2), 32,
     32, 3_813_888),
    ("row 13 chunk_lookup_comp idx [128, 1, 32]", "chunk_lookup_comp",
     (128, 1), 32, 4, 3_649_024),
)
# the warp-steps a gather block's warp takes (its warps: as many as its
# rows need at that many steps each)
GSTEPS_LINE = "constexpr int kGatherSteps = 1;\n"
GATHER_STEPS = (1, 2, 4, 8)
# where a gather warp releases the dependent launch: after its first row
# loads (this source) or, in a copy, as the kernel starts
TRIGGER_LINES = (
    ("      if (!triggered) {\n"
     "        grid_dependents_launch();\n"
     "        triggered = true;\n"
     "      }\n", ""),
    ("  using V = typename Vec::T;\n",
     "  using V = typename Vec::T;\n  grid_dependents_launch();\n"),
)
# rows 6 and 8 of PERF.md's kernel table: (what, U, W, source rows, refs
# entries or 0), and the dense read batch's dedup pair: (indir shape, U,
# W, arena rows)
GATHER_SHAPES = (
    ("row 6 gather_rows uniq_idx [2048]", 2048, 32, 3_813_888, 0),
    ("row 8 gather_rows_compressed uniq_idx [1024]", 1024, 4, 16_384,
     3_649_024),
)
PAIR_SHAPE = ((32, 2, 128), 2048, 32, 3_813_888)
# the entry points both libraries must share for --against, and the
# kernels whose SASS must not change: the six older split kernels (not
# dedup_kernel, whose body waits for the gather) and unpack_kernel
SHARED = ("cobs_vertical", "cobs_lookup", "cobs_lookup_comp",
          "cobs_chunk_dedup", "cobs_dedup_score", "cobs_unpack",
          "cobs_chunk_lookup", "cobs_chunk_lookup_comp", "cobs_gather_rows",
          "cobs_gather_rows_comp")
SHARED_KERNELS = ("vertical_kernel", "lookup_kernel", "lookup_comp_kernel",
                  "chunk_lookup_kernel", "chunk_lookup_comp_kernel",
                  "chunk_dedup_kernel", "unpack_kernel")
# --tune: chip_smoke.py's dense index (rows, W, hashes, blocks), its read
# batch shape (bucket, batch), and the fixture rows past the 50 MB L2
TUNE_GEOMETRY = (3_813_888, 32, 1, 2)
TUNE_SHAPE = (128, 32)
BIG_TUNE_ROWS = 1 << 20
TUNE_ROUNDS = 3
TUNE_MEASURES = ("_measure_fused", "_measure_dedup", "_measure_plan_host",
                 "_measure_add")


def log(*parts) -> None:
    print(*parts, flush=True)


def nvcc_build(build, src: Path, out: Path) -> subprocess.Popen:
    """Start nvcc on ``src`` with the port's flags; returns the process."""
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen, what: str) -> str:
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"split_probe: nvcc failed on {what}:\n{report}")
    return report


def kernel_name(mangled: str) -> str:
    """A kernel's name in a mangled symbol _ZN<len><part>...E<args>: its
    part that ends in _kernel, after any namespace inside the anonymous
    one (grouped::lookup_kernel), and a template's ILi<n>EE as <n>
    (gather_kernel<4>)."""
    at = mangled.find("_ZN")
    parts, i = [], at + 3
    while at >= 0 and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    if not parts or not parts[-1].endswith("_kernel"):
        return mangled.strip()
    ns = [p for p in parts[:-1] if not p.startswith("_")]
    m = re.match(r"ILi(\d+)EE", mangled[i:])
    return "::".join(ns + [parts[-1]]) + (f"<{m.group(1)}>" if m else "")


def ptxas_lines(report: str) -> dict[str, str]:
    out, kernel = {}, "?"
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line)
        elif "Used" in line or "spill" in line:
            out[kernel] = (out.get(kernel, "") + " "
                           + line.split(":", 1)[-1].strip()).strip()
    return out


def sass(lib: Path, tool: Path) -> dict[str, str] | None:
    """Each kernel's SASS in ``lib`` without its (file-hashed) name line,
    each run of blanks as one space (cuobjdump pads every line to the
    widest instruction of the whole library), or None when ``tool``
    (cuobjdump) is not there."""
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name_line, _, body = part.partition("\n")
        if re.search(r"\d+([A-Za-z_]+_kernel)", name_line):
            out[kernel_name(name_line)] = re.sub(
                r"[ \t]+", " ", body.split("\n\t\t......")[0])
    return out


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def graph_ms(torch, call, n: int = 64, rounds: int = 5) -> float:
    s = torch.cuda.current_stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s, capture_error_mode="thread_local"):
        for _ in range(n):
            call()
    graph.replay()
    s.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(s)
        graph.replay()
        b.record(s)
        b.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def checked(torch, what, call, out, want) -> None:
    err = call()
    if err != 0:
        raise SystemExit(f"split_probe: {what}: CUDA error {err}")
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        bad = int((out != want).sum())
        raise SystemExit(f"split_probe: {what}: {bad} counts differ from the "
                         f"plain version")


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f"nvidia-smi failed: {proc.stderr.strip()}"


def chunk_inputs(torch, g, dev):
    uniq = torch.randint(-2 ** 31, 2 ** 31, (1024, 8), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)
    indir = torch.randint(0, 1024, (32, 1, 32), generator=g,
                          dtype=torch.int32).to(dev)
    mask = (torch.rand((32, 1, 32), generator=g) < 0.9).to(
        torch.int32).to(dev)
    acc = torch.randint(0, 50, (32, 1, 8, 32), generator=g,
                        dtype=torch.int32).to(dev)
    return uniq, indir, mask, acc


def probe_geometry(torch, k, libs, inputs, dev_i, stream) -> dict:
    """Row 11's shape at each slice count of ``libs`` and clusters 1, 2."""
    uniq, indir, mask, acc = inputs
    Q, nb, L = indir.shape
    W, Wp = uniq.shape[1], acc.shape[2]
    want = k.chunk_plain(uniq, indir, mask, acc)
    out = torch.empty_like(acc)
    res = {}
    for S, lib in libs.items():
        for cs in (1, 2):
            def call(lib=lib, cs=cs):
                return lib.cobs_chunk_dedup(
                    uniq.data_ptr(), indir.data_ptr(), mask.data_ptr(),
                    acc.data_ptr(), out.data_ptr(), Q * nb, L, W, Wp, cs,
                    dev_i, stream())
            checked(torch, f"chunk_dedup {S} slices cluster {cs}", call, out,
                    want)
            res[f"{S} slices, cluster {cs}"] = graph_ms(torch, call)
    return res


def probe_lengths(torch, k, lib, inputs, dev_i, stream) -> dict:
    """The row-11 inputs tiled to each of CHUNK_LENGTHS through the three
    split chunk kernels and the split body without running counts."""
    uniq, indir, mask, acc = inputs
    Q, nb, Lc = indir.shape
    W, Wp = uniq.shape[1], acc.shape[2]
    refs = torch.arange(uniq.shape[0], dtype=torch.int32,
                        device=uniq.device)
    ms = {"chunk_dedup (cobs_chunk_dedup)": {},
          "chunk_lookup (cobs_chunk_lookup)": {},
          "chunk_lookup_comp (cobs_chunk_lookup_comp)": {},
          "split without acc (cobs_dedup_score)": {}}
    for L in CHUNK_LENGTHS:
        reps = -(-L // Lc)
        ind = indir.repeat(1, 1, reps)[..., :L].contiguous()
        msk = mask.repeat(1, 1, reps)[..., :L].contiguous()
        out = torch.empty_like(acc)
        out2 = torch.empty((Q, nb, W, 32), dtype=torch.int32,
                           device=acc.device)
        tail = (acc.data_ptr(), out.data_ptr(), Q * nb, L, W, Wp, 0, dev_i)
        want = k.chunk_plain(uniq, ind, msk, acc)
        calls = (
            (lambda: lib.cobs_chunk_dedup(
                uniq.data_ptr(), ind.data_ptr(), msk.data_ptr(), *tail,
                stream()), out, want),
            (lambda: lib.cobs_chunk_lookup(
                uniq.data_ptr(), ind.data_ptr(), msk.data_ptr(), *tail,
                stream()), out, want),
            (lambda: lib.cobs_chunk_lookup_comp(
                uniq.data_ptr(), refs.data_ptr(), ind.data_ptr(),
                msk.data_ptr(), *tail, stream()), out, want),
            (lambda: lib.cobs_dedup_score(
                uniq.data_ptr(), ind.data_ptr(), msk.data_ptr(),
                out2.data_ptr(), Q * nb, L, W, 0, dev_i, stream()),
             out2, k.lookup_plain(uniq, ind, msk)))
        for body, (call, o, w) in zip(ms, calls):
            checked(torch, f"{body} at L={L}", call, o, w)
            ms[body][L] = graph_ms(torch, call)
    lo, hi = CHUNK_LENGTHS[1], CHUNK_LENGTHS[2]
    return {"ms": ms, "per_term_ms": {
        body: (t[hi] - t[lo]) / (hi - lo) for body, t in ms.items()}}


def probe_wcut(torch, k, libs, dev_i, stream, g) -> dict:
    """Row 13's chunk_lookup_comp with the word tile cut from Wp (this
    source) and from W (the copy), in the order this, copy, copy, this,
    three times over."""
    dev = torch.device("cuda", dev_i)
    lead, L, W, Wp, D, R = ROW13
    cells = lead[0] * lead[1]
    dict_rows = torch.randint(-2 ** 31, 2 ** 31, (D, W), generator=g,
                              dtype=torch.int64).to(torch.int32).to(dev)
    refs = torch.randint(0, D, (R,), generator=g, dtype=torch.int32).to(dev)
    idx = torch.randint(0, R, lead + (L,), generator=g,
                        dtype=torch.int32).to(dev)
    mask = (torch.rand(lead + (L,), generator=g) < 0.95).to(
        torch.int32).to(dev)
    acc = torch.randint(0, 50, lead + (Wp, 32), generator=g,
                        dtype=torch.int32).to(dev)
    want = k.chunk_plain(dict_rows, idx, mask, acc, refs)
    out = torch.empty_like(acc)

    def call(lib):
        return lib.cobs_chunk_lookup_comp(
            dict_rows.data_ptr(), refs.data_ptr(), idx.data_ptr(),
            mask.data_ptr(), acc.data_ptr(), out.data_ptr(), cells, L, W, Wp,
            0, dev_i, stream())
    runs = {"this": [], "copy": []}
    for side in runs:
        checked(torch, f"row 13 ({side})", lambda: call(libs[side]), out,
                want)
    for _ in range(3):
        for side in ("this", "copy", "copy", "this"):
            runs[side].append(graph_ms(torch, lambda: call(libs[side])))
    return runs


def probe_unpack(torch, k, libs, dev_i, stream, g, other=None) -> dict:
    """unpack_kernel at UNPACK_SHAPES with each warp count of ``libs``, at
    clusters 1, 2 and the entry point's choice (0), vertical_kernel at the
    same rows (the first library's), and the ``other`` library's
    cobs_unpack when given."""
    res = {}
    dev = torch.device("cuda", dev_i)
    for what, L, W in UNPACK_SHAPES:
        rows = torch.randint(-2 ** 31, 2 ** 31, (1, L, W), generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)
        want = k.unpack_score_plain(rows)
        out = torch.empty_like(want)
        times = {}
        for warps, lib in libs.items():
            for cs in (1, 2, 0):
                def call(lib=lib, cs=cs):
                    return lib.cobs_unpack(rows.data_ptr(), out.data_ptr(),
                                           1, L, W, cs, dev_i, stream())
                key = f"unpack {warps} warps, cluster {cs or 'auto'}"
                checked(torch, f"{what} {key}", call, out, want)
                times[key] = graph_ms(torch, call)
        lib = libs[WARPS[0]]

        def vert():
            return lib.cobs_vertical(rows.data_ptr(), out.data_ptr(), 1, L,
                                     W, 0, dev_i, stream())
        checked(torch, f"{what} vertical", vert, out, want)
        times["vertical, cluster auto"] = graph_ms(torch, vert)
        if other is not None:
            def unpack_o():
                return other.cobs_unpack(rows.data_ptr(), out.data_ptr(), 1,
                                         L, W, 0, dev_i, stream())
            checked(torch, f"{what} other unpack", unpack_o, out, want)
            times["other unpack"] = graph_ms(torch, unpack_o)
        res[what] = times
    return res


def probe_against(torch, k, libs, dev_i, stream, g, planes) -> dict:
    """Both libraries' entry points at MAIN_SHAPES, in the order this,
    other, other, this, three times over. ``planes``: the other library's
    chunk lookups take a counter-plane count where this one's take a
    cluster size."""
    res = {}
    dev = torch.device("cuda", dev_i)
    dict_rows = {"lookup_comp": 4096, "chunk_lookup_comp": ROW13[4]}

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)
    for what, kernel, lead, L, W, rows in MAIN_SHAPES:
        cells = 1
        for n in lead:
            cells *= n
        chunk = kernel.startswith("chunk_")
        if kernel in ("vertical", "unpack"):
            src = ints(-2 ** 31, 2 ** 31, *lead, L, W)
            want = k.vertical_score_plain(src)
            out = torch.empty_like(want)
            args = (src.data_ptr(), out.data_ptr(), lead[0], L, W)
        else:
            table = ints(-2 ** 31, 2 ** 31, dict_rows.get(kernel, rows), W)
            idx = ints(0, rows, *lead, L)
            mask = (torch.rand(lead + (L,), generator=g) < 0.95).to(
                torch.int32).to(dev)
            head = (table.data_ptr(),)
            refs = None
            if kernel in dict_rows:
                refs = ints(0, table.shape[0], rows)
                head += (refs.data_ptr(),)
            if chunk:
                Wp = ROW13[3] if kernel == "chunk_lookup_comp" else W
                acc = ints(0, 50, *lead, Wp, 32)
                want = k.chunk_plain(table, idx, mask, acc, refs)
            elif refs is not None:
                want = k.lookup_comp_plain(table, refs, idx, mask)
            else:
                want = k.lookup_plain(table, idx, mask)
            out = torch.empty_like(want)
            tail = (out.data_ptr(), cells, L, W)
            if chunk:
                tail = (acc.data_ptr(),) + tail + (Wp,)
            args = head + (idx.data_ptr(), mask.data_ptr()) + tail

        def call(lib, side, kernel=kernel, args=args, L=L):
            last = (k.num_planes(L) if side == "other" and planes
                    and kernel.startswith("chunk_lookup") else 0)
            return getattr(lib, f"cobs_{kernel}")(*args, last, dev_i,
                                                  stream())
        runs = {"this": [], "other": []}
        for side in ("this", "other"):
            checked(torch, f"{what} ({side})",
                    lambda: call(libs[side], side), out, want)
        for _ in range(3):
            for side in ("this", "other", "other", "this"):
                runs[side].append(graph_ms(
                    torch, lambda: call(libs[side], side)))
        res[what] = runs
        del want, out
        torch.cuda.empty_cache()
    return res


def probe_gathers(torch, k, libs, order, dev_i, stream, g,
                  fused: bool) -> dict:
    """The gathers of ``libs`` (name -> library) at GATHER_SHAPES and their
    dedup pairs at PAIR_SHAPE, each checked, then timed in ``order`` three
    times over; with ``fused``, beside the first library's fused lookup of
    the pair's batch (the indices expanded)."""
    res = {}
    dev = torch.device("cuda", dev_i)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)
    for what, U, W, R, n_refs in GATHER_SHAPES:
        table = ints(-2 ** 31, 2 ** 31, R, W)
        out = torch.empty((U, W), dtype=torch.int32, device=dev)
        if n_refs:
            refs = ints(0, R, n_refs)
            idx = ints(0, n_refs, U)
            want = k.gather_comp_plain(table, refs, idx)

            def call(lib, refs=refs, idx=idx, table=table, U=U, W=W,
                     out=out):
                return lib.cobs_gather_rows_comp(
                    table.data_ptr(), refs.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), U, 1, W, dev_i, stream())
        else:
            idx = ints(0, R, U)
            want = k.gather_plain(table, idx)

            def call(lib, idx=idx, table=table, U=U, W=W, out=out):
                return lib.cobs_gather_rows(table.data_ptr(), idx.data_ptr(),
                                            out.data_ptr(), U, 1, W, dev_i,
                                            stream())
        res[what] = in_turns(torch, libs, order, what, call, out, want)
    (Q, nb, L), U, W, R = PAIR_SHAPE
    arena = ints(-2 ** 31, 2 ** 31, R, W)
    uniq_idx = ints(0, R, U)
    indir = ints(0, U, Q, nb, L)
    mask = (torch.rand((Q, nb, L), generator=g) < 0.95).to(
        torch.int32).to(dev)
    uniq = torch.empty((U, W), dtype=torch.int32, device=dev)
    out = torch.empty((Q, nb, W, 32), dtype=torch.int32, device=dev)
    want = k.lookup_plain(arena, uniq_idx[indir.long()], mask)

    def pair(lib):
        err = lib.cobs_gather_rows(arena.data_ptr(), uniq_idx.data_ptr(),
                                   uniq.data_ptr(), U, 1, W, dev_i, stream())
        return err or lib.cobs_dedup_score(
            uniq.data_ptr(), indir.data_ptr(), mask.data_ptr(),
            out.data_ptr(), Q * nb, L, W, 0, dev_i, stream())
    what = f"dedup pair indir [{Q}, {nb}, {L}], uniq [{U}, {W}]"
    res[what] = in_turns(torch, libs, order, what, pair, out, want)
    if fused:
        expanded = uniq_idx.long()[indir.long()].to(torch.int32).contiguous()
        lib = libs[order[0]]
        out2 = torch.empty_like(out)

        def lookup():
            return lib.cobs_lookup(arena.data_ptr(), expanded.data_ptr(),
                                   mask.data_ptr(), out2.data_ptr(), Q * nb,
                                   L, W, 0, dev_i, stream())
        checked(torch, "fused lookup of the pair's batch", lookup, out2,
                want)
        res[what][f"fused ({order[0]})"] = [graph_ms(torch, lookup)
                                            for _ in range(3)]
    return res


def in_turns(torch, libs, order, what, call, out, want) -> dict:
    """``call(lib)`` checked for each library, then timed in ``order``
    three times over."""
    runs = {side: [] for side in libs}
    for side in runs:
        out.zero_()
        checked(torch, f"{what} ({side})", lambda: call(libs[side]), out,
                want)
    for _ in range(3):
        for side in order:
            runs[side].append(graph_ms(torch, lambda: call(libs[side])))
    return runs


def record_measures(tuner) -> list:
    """Wraps the tuner's measurements (looked up on the instance at call
    time) so that each call's name, arguments and result are kept: the
    components of its break-even fit. Changes nothing it measures."""
    calls = []
    for name in TUNE_MEASURES:
        def rec(*args, _name=name, _fn=getattr(tuner, name), **kw):
            out = _fn(*args, **kw)
            calls.append((_name, args, out))
            return out
        setattr(tuner, name, rec)
    return calls


def measures_line(calls) -> str:
    """The recorded measurements in us (a dedup call also gives its padded
    unique rows)."""
    parts = []
    for name, args, out in calls:
        what = name.removeprefix("_measure_")
        if what == "add":
            what = args[0]
        if isinstance(out, tuple):
            parts.append(f"{what}(U={out[1]}) {out[0] * 1e6:.1f}")
        else:
            parts.append(f"{what} {out * 1e6:.1f}")
    return ", ".join(parts)


def probe_tune(torch) -> dict:
    """Fresh tunes of the dense read shape at the default fixture cap and
    past the L2, TUNE_ROUNDS rounds."""
    from repro_torch.kernels.autotune import KernelTuner, TuningCache
    rows = []
    for r in range(TUNE_ROUNDS):
        for label, kw in (("fresh 1", {}), ("fresh 2", {}),
                          ("past L2", {"max_tune_rows": BIG_TUNE_ROWS})):
            t0 = time.perf_counter()
            t = KernelTuner(*TUNE_GEOMETRY, TuningCache(), **kw)
            calls = record_measures(t)
            costs = {m: e.cost_us for m, e in t.costs(*TUNE_SHAPE).items()}
            thr = t.entry("lookup", *TUNE_SHAPE).dedup_threshold
            row = {"round": r + 1, "label": label,
                   "tune_rows": int(t._tune_arena().shape[0]),
                   "dedup_threshold": thr, "costs_us": costs,
                   "cheapest": min(costs, key=costs.get),
                   "measures": measures_line(calls),
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            log(f"[tune] round {r + 1} {label}, {row['tune_rows']} fixture "
                f"rows: dedup threshold {thr}; costs (us) "
                + ", ".join(f"{m} {c:.1f}" for m, c in sorted(costs.items()))
                + f"; cheapest {row['cheapest']}; {row['seconds']:.2f} s; "
                  f"measured (us) {row['measures']}")
    torch.cuda.synchronize()
    return {"geometry": list(TUNE_GEOMETRY), "shape": list(TUNE_SHAPE),
            "tunes": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="a checkout of another commit to compare with")
    ap.add_argument("--tune", action="store_true",
                    help="ask only the kernel tuner's questions")
    args = ap.parse_args()
    if not (ROOT / SOURCE_REL).is_file():
        print("split_probe: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("split_probe: CUDA is not available", file=sys.stderr)
        return 2
    if args.tune:
        rec = {"card": card_line(), "torch": torch.__version__,
               "cuda": torch.version.cuda, **probe_tune(torch)}
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "tune_probe.json").write_text(json.dumps(rec, indent=1))
        print(rec["card"])
        return 0
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitslice_score as k
    text = (ROOT / SOURCE_REL).read_text()
    for line, what in ((SLICE_LINE, "split_body's slice count"),
                       (WARPS_LINE, "kUnpackWarps"),
                       (GSTEPS_LINE, "kGatherSteps"),
                       *((old, "gather_body's trigger")
                         for old, _ in TRIGGER_LINES),
                       *((old, "split_body's word tile")
                         for old, _ in WCUT_LINES)):
        if text.count(line) != 1:
            print(f"split_probe: {what} line has changed; update "
                  f"split_probe.py", file=sys.stderr)
            return 2
    # every library at once, one nvcc each
    procs, paths = {}, {}
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    for S in SLICES:
        src = PROBE_DIR / f"slices{S}.cu"
        src.write_text(text if S == SLICES[0] else text.replace(
            SLICE_LINE, f"  const int wt = g.wt, S = g.slices < {S} ? "
                        f"g.slices : {S};\n"))
        paths[S] = PROBE_DIR / f"slices{S}.so"
        procs[S] = nvcc_build(_build, src, paths[S])
    for n in WARPS[1:]:
        key = f"warps{n}"
        src = PROBE_DIR / f"{key}.cu"
        src.write_text(text.replace(WARPS_LINE, WARPS_LINE.replace(
            "kUnpackWarps = 8;", f"kUnpackWarps = {n};")))
        paths[key] = PROBE_DIR / f"{key}.so"
        procs[key] = nvcc_build(_build, src, paths[key])
    for n in GATHER_STEPS[1:]:
        key = f"gsteps{n}"
        src = PROBE_DIR / f"{key}.cu"
        src.write_text(text.replace(GSTEPS_LINE, GSTEPS_LINE.replace(
            "= 1;", f"= {n};")))
        paths[key] = PROBE_DIR / f"{key}.so"
        procs[key] = nvcc_build(_build, src, paths[key])
    entry = text
    for old, new in TRIGGER_LINES:
        entry = entry.replace(old, new)
    (PROBE_DIR / "trigger.cu").write_text(entry)
    paths["trigger"] = PROBE_DIR / "trigger.so"
    procs["trigger"] = nvcc_build(_build, PROBE_DIR / "trigger.cu",
                                  paths["trigger"])
    wcut = text
    for old, new in WCUT_LINES:
        wcut = wcut.replace(old, new)
    (PROBE_DIR / "wcut.cu").write_text(wcut)
    paths["wcut"] = PROBE_DIR / "wcut.so"
    procs["wcut"] = nvcc_build(_build, PROBE_DIR / "wcut.cu", paths["wcut"])
    if args.against is not None:
        paths["other"] = PROBE_DIR / "other.so"
        procs["other"] = nvcc_build(_build, args.against / SOURCE_REL,
                                    paths["other"])
    reports = {key: finish(p, str(key)) for key, p in procs.items()}
    libs = {S: load(paths[S], _build._SIGNATURES) for S in SLICES}
    warp_libs = {WARPS[0]: libs[SLICES[0]], **{
        n: load(paths[f"warps{n}"], _build._SIGNATURES) for n in WARPS[1:]}}
    gstep_libs = {GATHER_STEPS[0]: libs[SLICES[0]], **{
        n: load(paths[f"gsteps{n}"], _build._SIGNATURES)
        for n in GATHER_STEPS[1:]}}
    rec = {"card": card_line(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "ptxas": {str(key): ptxas_lines(r) for key, r in reports.items()}}
    for key, lines in rec["ptxas"].items():
        for kern in (*SHARED_KERNELS, "dedup_kernel",
                     *(f"{name}<{v}>" for name in ("gather_kernel",
                                                   "gather_comp_kernel")
                       for v in (4, 2, 1))):
            if kern in lines:
                log(f"[ptxas] {key}: {kern}: {lines[kern]}")
    dev_i = torch.cuda.current_device()
    g = torch.Generator().manual_seed(0)
    with torch.cuda.stream(torch.cuda.Stream()):
        def stream():
            return torch.cuda.current_stream().cuda_stream
        inputs = chunk_inputs(torch, g, torch.device("cuda", dev_i))
        rec["geometry_ms"] = probe_geometry(torch, k, libs, inputs, dev_i,
                                            stream)
        for what, t in rec["geometry_ms"].items():
            log(f"[geometry] chunk_dedup at indir [32, 1, 32], Wp = W = 8, "
                f"{what}: {t * 1e3:.2f} us")
        rec["lengths"] = probe_lengths(torch, k, libs[SLICES[0]], inputs,
                                       dev_i, stream)
        for body, times in rec["lengths"]["ms"].items():
            log(f"[lengths] {body}: " + ", ".join(
                f"L {L}: {t * 1e3:.2f} us" for L, t in times.items())
                + f"; {rec['lengths']['per_term_ms'][body] * 1e3:.4f} us a "
                  f"term from L {CHUNK_LENGTHS[1]} to {CHUNK_LENGTHS[2]}")
        rec["wcut_ms"] = probe_wcut(
            torch, k, {"this": libs[SLICES[0]],
                       "copy": load(paths["wcut"], _build._SIGNATURES)},
            dev_i, stream, g)
        log("[wcut] row 13 chunk_lookup_comp, word tile from Wp = 8 (this): "
            + ", ".join(f"{t * 1e3:.2f}" for t in rec["wcut_ms"]["this"])
            + " us; from W = 4 (copy): "
            + ", ".join(f"{t * 1e3:.2f}" for t in rec["wcut_ms"]["copy"])
            + " us")
        other = None
        if args.against is not None:
            other = load(paths["other"], {
                "cobs_unpack": _build._SIGNATURES["cobs_unpack"]})
        rec["unpack_ms"] = probe_unpack(torch, k, warp_libs, dev_i, stream,
                                        g, other)
        for what, times in rec["unpack_ms"].items():
            log(f"[unpack] {what}: " + ", ".join(
                f"{key} {t * 1e3:.2f} us" for key, t in times.items()))
        if args.against is not None:
            tool = Path(_build._nvcc()).with_name("cuobjdump")
            this = sass(paths[SLICES[0]], tool)
            other = sass(paths["other"], tool)
            rec["same_sass"] = None if this is None else {
                kern: this.get(kern) == other.get(kern)
                for kern in SHARED_KERNELS}
            log(f"[against] {args.against}: same SASS {rec['same_sass']}")
            other_lib = load(paths["other"], {
                name: _build._SIGNATURES[name] for name in SHARED})
            planes = re.search(
                r"int cobs_chunk_lookup\([^)]*int n_planes",
                (args.against / SOURCE_REL).read_text()) is not None
            both = {"this": libs[SLICES[0]], "other": other_lib}
            rec["against"] = probe_against(torch, k, both, dev_i, stream, g,
                                           planes)
            rec["against"].update(probe_gathers(
                torch, k, both, ("this", "other", "other", "this"), dev_i,
                stream, g, fused=True))
            for what, runs in rec["against"].items():
                log(f"[against] {what}: this " + ", ".join(
                    f"{t * 1e3:.2f}" for t in runs["this"]) + " us; other "
                    + ", ".join(f"{t * 1e3:.2f}" for t in runs["other"])
                    + f" us; medians {statistics.median(runs['this']) * 1e3:.2f}"
                    f" / {statistics.median(runs['other']) * 1e3:.2f}"
                    + ("; fused (this) " + ", ".join(
                        f"{t * 1e3:.2f}" for t in runs["fused (this)"])
                       + " us" if "fused (this)" in runs else ""))
        rec["gather_steps_ms"] = probe_gathers(
            torch, k, {n: gstep_libs[n] for n in GATHER_STEPS},
            GATHER_STEPS + GATHER_STEPS[::-1], dev_i, stream, g,
            fused=False)
        for what, runs in rec["gather_steps_ms"].items():
            log(f"[gather steps] {what}: " + "; ".join(
                f"{n} a warp " + ", ".join(f"{t * 1e3:.2f}" for t in ts)
                + " us" for n, ts in runs.items()))
        trig = {"after loads": libs[SLICES[0]],
                "at entry": load(paths["trigger"], _build._SIGNATURES)}
        rec["trigger_ms"] = probe_gathers(
            torch, k, trig, ("after loads", "at entry", "at entry",
                             "after loads"), dev_i, stream, g, fused=False)
        for what, runs in rec["trigger_ms"].items():
            log(f"[trigger] {what}: " + "; ".join(
                f"{n} " + ", ".join(f"{t * 1e3:.2f}" for t in ts) + " us"
                for n, ts in runs.items()))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "split_probe.json").write_text(json.dumps(rec, indent=1))
    print(rec["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
