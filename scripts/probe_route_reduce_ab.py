#!/usr/bin/env python3
"""A/B of the PyTorch port's K19 (route_rows) and K21 (reduce_requests)
CUDA kernels against another checkout's, on one GPU, launch by launch.

    python3 scripts/probe_route_reduce_ab.py [--baseline DIR] [--scale F]
                                             [--only k19|k21] [--seed S]

DIR is the root of another checkout (e.g. `git archive <commit>
sage2_tpu_torch | tar -x -C .smoke_checkout/parent`); both checkouts'
route_rows.cu and reduce_requests.cu are compiled with the same nvcc
flags (-Xptxas -v printed for each) and called through their own C
interface, which the script tells apart by its symbols:

  K19 three launches (count, the single-block scan of the tile counts,
      write) around a host read of the bin starts, or two (histogram,
      the single-pass scatter) around a host read of the bin totals;
  K21 ranges over the whole adjacency, or a vertex row table and ranges
      within w's run; a torch.cumsum and a host read of the total; the
      expansion (one thread a request, or a merge-path split of the
      slots); the probe (a search of the whole edge list, or of v's run).

Inputs, made on the card from a seed at the four-shard mesh's sizes on
the E. coli-scale reads (chip_smoke.py phase 12; --scale shrinks them):

  K19 303,847,639 rows of 3 int32 (the reduction's candidates) with
      owners uniform over 4 shards and 95% of them valid, one-way and
      two-way; 283,360,392 int64 keys routed by their hash, the rows the
      keys themselves (the voting rule's lookups of phase 13b), two-way;
  K21 one shard of an overlap graph: reads at positions with gaps of
      mean 3.1 (out-degree ~19 at offsets sl <= 60, as the 50x graph's
      84,455,952 edges over 4.6 M vertices), vertex ids a random
      permutation of the positions (read ids), 1,150,000 vertices a shard,
      the (src, sl) and (src, dst) orders padded to 36,800,000 rows; the
      requests of every edge into the shard's range (~21 M) with the
      reference's bound maxsl(v) - sl_vw; the probe takes the
      candidates the expansion made.

Each launch is timed apart (median of 5 CUDA-event timings after a
warm-up), old and new in turns, then the whole call of each; every
output of the two checkouts is compared bit for bit, and K19's
destination order with torch.sort(owner, stable=True), whose time is
printed beside. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms, time_ms  # noqa: E402

CSRC = os.path.join("sage2_tpu_torch", "kernels", "csrc")
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the C interfaces, old (count/scan/write; ranges over the whole
# adjacency) and new (histogram/scatter; the vertex row table)
SIGS = {
    "sage2_route_count": [P, P, I, P, I64, I, P, P],
    "sage2_scan_tiles": [P, I64, P, P],
    "sage2_route_write": [P, P, I, P, I64, I, I, P, I, P, P, P, P, P, P, P],
    "sage2_route_hist": [P, P, I, P, I64, I, P, P],
    "sage2_route_scatter": [P, P, I, P, I64, I, I, P, I, I, P, P, P, P, P,
                            P, P],
    "sage2_reduce_rows": [P, I64, I64, I64, P, P],
}
OLD_K21 = {
    "sage2_reduce_ranges": [P, I64, P, I64, P, P, P],
    "sage2_reduce_expand": [P, P, P, I64, P, P, P, I64, P, P, P],
    "sage2_reduce_probe": [P, P, P, I64, P, I64, I, P, I64, I64, P, P],
}
NEW_K21 = {
    "sage2_reduce_ranges": [P, P, I64, I64, P, I64, P, P, P],
    "sage2_reduce_expand": [P, P, P, I64, P, P, I64, P, P, P],
    "sage2_reduce_probe": [P, P, P, I64, I64, P, I64, I, P, I64, P, P],
}
# rows a tile of the new K19 (kTile in route_rows.cu)
ROUTE_TILE = 2048


def build(root: str, name: str, outdir: str, tag: str):
    from sage2_tpu_torch.kernels import nvcc_command

    src = os.path.join(root, CSRC, name + ".cu")
    so = os.path.join(outdir, f"{name}-{tag}.so")
    cmd = nvcc_command() + ["-Xptxas", "-v", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"nvcc {src}: {res.stderr}")
    for line in res.stderr.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas {tag} {name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    new_k21 = hasattr(lib, "sage2_reduce_rows")
    for fn, sig in {**SIGS, **(NEW_K21 if new_k21 else OLD_K21)}.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = I
    return lib


def call(lib, fn, *args):
    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


def ptr(t):
    return None if t is None else t.data_ptr()


class K19:
    """One checkout's K19 through its own C interface: ``run`` returns
    its outputs (send, offsets; dest, rank, sent_ok where written),
    ``split`` each launch's time."""

    def __init__(self, lib, tag):
        self.lib, self.tag = lib, tag
        self.new = hasattr(lib, "sage2_route_hist")

    def parts(self, rows, n, cap, owner, keys, flip, valid, answers):
        """The call as a list of (part, fn) steps and a closure of its
        outputs."""
        import torch

        Q, K = rows.shape
        dev = rows.device
        stream = torch.cuda.current_stream().cuda_stream
        src = (ptr(owner), ptr(keys), int(flip), ptr(valid), Q, n)
        st = {}
        two_way = answers or not self.new
        if two_way:
            st["dest"] = torch.empty(Q, dtype=torch.int32, device=dev)
            st["rank"] = torch.empty(Q, dtype=torch.int32, device=dev)
            st["sent_ok"] = torch.empty(Q, dtype=torch.bool, device=dev)
        st["offsets"] = torch.empty(n, dtype=torch.int64, device=dev)

        def sized(per):
            st["send"] = torch.empty((sum(min(c, cap) for c in per), K),
                                     dtype=torch.int32, device=dev)

        if self.new:
            tiles = max(1, -(-Q // ROUTE_TILE))
            scratch = torch.empty(n + 1 + tiles * (n + 1), dtype=torch.int64,
                                  device=dev)

            def hist():
                call(self.lib, "sage2_route_hist", *src, ptr(scratch), stream)

            def read():
                sized(scratch[:n].tolist())

            key_rows = int(keys is not None and K == 2
                           and rows.data_ptr() == keys.data_ptr())

            def scatter():
                call(self.lib, "sage2_route_scatter", *src, cap, ptr(rows),
                     K, key_rows, ptr(scratch), ptr(st.get("dest")),
                     ptr(st.get("rank")), ptr(st.get("sent_ok")),
                     ptr(st["send"]), ptr(st["offsets"]), stream)

            steps = [("histogram", hist), ("host read", read),
                     ("scatter", scatter)]
        else:
            tiles = max(1, -(-Q // 1024))
            scratch = torch.empty((n + 1) * tiles + 1, dtype=torch.int64,
                                  device=dev)
            counts, total = scratch[:-1], scratch[-1:]

            def count():
                call(self.lib, "sage2_route_count", *src, ptr(counts), stream)

            def scan():
                call(self.lib, "sage2_scan_tiles", ptr(counts),
                     counts.numel(), ptr(total), stream)

            def read():
                starts = counts.view(n + 1, tiles)[:, 0].tolist() + [Q]
                sized([starts[d + 1] - starts[d] for d in range(n)])

            def write():
                call(self.lib, "sage2_route_write", *src, cap, ptr(rows), K,
                     ptr(counts), ptr(st["dest"]), ptr(st["rank"]),
                     ptr(st["sent_ok"]), ptr(st["send"]), ptr(st["offsets"]),
                     stream)

            steps = [("count", count), ("scan", scan), ("host read", read),
                     ("write", write)]
        return steps, st

    def run(self, *args):
        steps, st = self.parts(*args)
        for _, fn in steps:
            fn()
        return st

    def split(self, *args):
        """Each step's median ms (the host read too), and the call's."""
        return split_ms(self.parts(*args)[0])


class K21:
    """One checkout's K21 through its own C interface."""

    def __init__(self, lib, tag):
        self.lib, self.tag = lib, tag
        self.new = hasattr(lib, "sage2_reduce_rows")

    def steps(self, g, cand_cap):
        """The phase-2 call as (part, fn) steps over the graph ``g``, and
        its state (cand, ok, total)."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        dev = g["ss_key"].device
        E, R = g["ss_key"].numel(), g["req"].shape[0]
        st = {"start": torch.empty(R, dtype=torch.int64, device=dev),
              "counts": torch.empty(R, dtype=torch.int64, device=dev)}
        parts = []
        if self.new:
            st["row"] = torch.empty(g["v_d"] + 1, dtype=torch.int64,
                                    device=dev)
            parts.append(("rows", lambda: call(
                self.lib, "sage2_reduce_rows", ptr(g["ss_key"]), E,
                g["vbase"], g["v_d"], ptr(st["row"]), stream)))
            parts.append(("ranges", lambda: call(
                self.lib, "sage2_reduce_ranges", ptr(g["ss_key"]),
                ptr(st["row"]), g["vbase"], g["v_d"], ptr(g["req"]), R,
                ptr(st["start"]), ptr(st["counts"]), stream)))
        else:
            parts.append(("ranges", lambda: call(
                self.lib, "sage2_reduce_ranges", ptr(g["ss_key"]), E,
                ptr(g["req"]), R, ptr(st["start"]), ptr(st["counts"]),
                stream)))

        def cumsum():
            st["ends"] = torch.cumsum(st["counts"], 0)

        def read():
            st["total"] = int(st["ends"][-1])
            C = min(st["total"], cand_cap)
            st["cand"] = torch.empty((C, 3), dtype=torch.int32, device=dev)
            st["ok"] = torch.empty(C, dtype=torch.bool, device=dev)

        def expand():
            C = st["ok"].numel()
            if self.new:
                call(self.lib, "sage2_reduce_expand", ptr(g["ss_key"]),
                     ptr(g["ss_dst"]), ptr(g["req"]), R, ptr(st["start"]),
                     ptr(st["ends"]), C, ptr(st["cand"]), ptr(st["ok"]),
                     stream)
            else:
                call(self.lib, "sage2_reduce_expand", ptr(g["ss_key"]),
                     ptr(g["ss_dst"]), ptr(g["req"]), R, ptr(st["start"]),
                     ptr(st["counts"]), ptr(st["ends"]), C, ptr(st["cand"]),
                     ptr(st["ok"]), stream)

        parts += [("cumsum", cumsum), ("host read", read),
                  ("expand", expand)]
        return parts, st

    def probe(self, g, cand, st, lens=None):
        """The phase-4 launch on ``cand``: (fn, removed)."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        E, C = g["src"].numel(), cand.shape[0]
        removed = torch.zeros(E, dtype=torch.uint8, device=cand.device)
        if self.new:
            def fn():
                call(self.lib, "sage2_reduce_probe", ptr(g["dst"]),
                     ptr(g["ovl"]), ptr(st["row"]),
                     g["vbase"], g["v_d"], ptr(cand), C, g["read_len"],
                     ptr(lens), 0 if lens is None else lens.numel(),
                     ptr(removed), stream)
        else:
            def fn():
                call(self.lib, "sage2_reduce_probe", ptr(g["src"]),
                     ptr(g["dst"]), ptr(g["ovl"]), E, ptr(cand), C,
                     g["read_len"], ptr(lens), g["v_d"], g["vbase"],
                     ptr(removed), stream)
        return fn, removed


def split_ms(steps, reps: int = 5) -> dict:
    """Median ms of each (part, fn) step of a call, run in sequence with
    a CUDA event between steps, and of the whole call; after a warm-up."""
    import statistics

    import torch

    for _, fn in steps:
        fn()
    per = {part: [] for part, _ in steps}
    calls = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(
            len(steps) + 1)]
        ev[0].record()
        for i, (_, fn) in enumerate(steps):
            fn()
            ev[i + 1].record()
        ev[-1].synchronize()
        for i, (part, _) in enumerate(steps):
            per[part].append(ev[i].elapsed_time(ev[i + 1]))
        calls.append(ev[0].elapsed_time(ev[-1]))
    out = {part: statistics.median(v) for part, v in per.items()}
    out["call"] = statistics.median(calls)
    return out


def k19_inputs(gen, scale):
    import torch

    dev = torch.device("cuda")
    Q = int(303_847_639 * scale)
    rows = torch.randint(-2**31, 2**31 - 1, (Q, 3), generator=gen,
                         dtype=torch.int32, device=dev)
    owner = torch.randint(0, 4, (Q,), generator=gen, dtype=torch.int32,
                          device=dev)
    valid = torch.rand(Q, generator=gen, device=dev) < 0.95
    return rows, owner, valid


def graph_inputs(gen, scale):
    """One shard of a position overlap graph (see the module's doc)."""
    import torch

    dev = torch.device("cuda")
    I32_MAX = 2**31 - 1
    v_d = int(1_150_000 * scale)
    E_pad = int(36_800_000 * scale)
    margin = 64
    n_all = v_d + 2 * margin
    vbase = margin
    gaps = torch.randint(1, 6, (n_all,), generator=gen, device=dev)
    gaps = torch.where(torch.rand(n_all, generator=gen, device=dev) < 0.02,
                       gaps * 3, gaps)          # a few coverage gaps
    pos = torch.cumsum(gaps, 0)
    src, dst, sl = [], [], []
    ids = torch.arange(n_all, device=dev)
    for o in range(1, 61):
        j = ids[:-o]
        d = pos[o:] - pos[:-o]
        keep = d <= 60
        src.append(j[keep])
        dst.append(j[keep] + o)
        sl.append(d[keep])
    src, dst, sl = torch.cat(src), torch.cat(dst), torch.cat(sl)
    # vertex ids are read ids, unrelated to the positions: a shard's
    # requests name random vertices of its range
    perm = torch.randperm(n_all, generator=gen, device=dev)
    src, dst = perm[src], perm[dst]
    read_len = 100
    # the shard's own edges: src in [vbase, vbase + v_d), (src, dst) order
    mine = (src >= vbase) & (src < vbase + v_d)
    ms, md, msl = src[mine], dst[mine], sl[mine]
    o = torch.argsort(ms * n_all + md)
    ms, md, msl = ms[o], md[o], msl[o]
    E = ms.numel()
    if E > E_pad:
        raise ValueError(f"{E} edges overflow the {E_pad}-row padding")
    pad = E_pad - E
    full = torch.full((pad,), I32_MAX, dtype=torch.int64, device=dev)
    g_src = torch.cat([ms, full]).to(torch.int32)
    g_dst = torch.cat([md, full]).to(torch.int32)
    g_ovl = torch.cat([read_len - msl, torch.zeros(pad, dtype=torch.int64,
                                                   device=dev)]).to(
        torch.int32)
    sl_all = torch.cat([msl, full])
    ss_key, order = torch.sort((g_src.to(torch.int64) << 32) | sl_all,
                               stable=True)
    ss_dst = g_dst[order].contiguous()
    # maxsl of every vertex over all its edges, and the requests of the
    # edges into the shard's range
    maxsl = torch.full((n_all,), -1, dtype=torch.int64, device=dev)
    maxsl.scatter_reduce_(0, src, sl, "amax")
    into = (dst >= vbase) & (dst < vbase + v_d)
    rv, rw, rsl = src[into], dst[into], sl[into]
    o = torch.argsort(rv * n_all + rw)      # requests arrive by source
    rv, rw, rsl = rv[o], rw[o], rsl[o]
    bound = maxsl[rv] - rsl
    req = torch.stack([rv, rw, rsl, bound], 1).to(torch.int32).contiguous()
    return {"ss_key": ss_key, "ss_dst": ss_dst, "req": req, "src": g_src,
            "dst": g_dst, "ovl": g_ovl, "vbase": vbase, "v_d": v_d,
            "read_len": read_len, "E": E}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", choices=("k19", "k21"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    checkouts = [("new", ROOT)] + (
        [("old", args.baseline)] if args.baseline else [])
    libs = {}
    names = {"k19": ("route_rows",), "k21": ("reduce_requests",)}.get(
        args.only, ("route_rows", "reduce_requests"))
    for tag, root in checkouts:
        for name in names:
            libs[tag, name] = build(root, name, tmp, tag)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tags = [t for t, _ in checkouts]
    # old and new in turns: new, old, old, new
    turns = tags + tags[::-1] if len(tags) > 1 else tags

    def equal(a, b):
        return all(torch.equal(a[k], b[k]) for k in a if k in b)

    if args.only in (None, "k19"):
        k19 = {t: K19(libs[t, "route_rows"], t) for t in tags}
        rows, owner, valid = k19_inputs(gen, args.scale)
        Q = rows.shape[0]
        own = torch.where(valid, owner, 4)
        print(f"K19 rows: {Q} x 3 int32, 4 owners, "
              f"{int(valid.sum())} valid", flush=True)
        for answers in (False, True):
            mode = "two-way" if answers else "one-way"
            a = (rows, 4, Q, owner, None, False, valid, answers)
            outs = {t: k19[t].run(*a) for t in tags}
            same = len(tags) == 1 or equal(outs["new"], outs["old"])
            # the destination order: a stable sort of the owners
            s_idx = torch.sort(own, stable=True).indices
            order_ok = torch.equal(outs["new"]["send"],
                                   rows[s_idx[:outs["new"]["send"].shape[0]]])
            print(f"K19 rows {mode}: outputs equal {same}, send in "
                  f"stable-sort order {order_ok}", flush=True)
            del outs
            for t in turns:
                parts = k19[t].split(*a)
                print(f"K19 rows {mode} {t} ({'histogram/scatter' if k19[t].new else 'count/scan/write'}): "
                      + ", ".join(f"{p} {ms:.4f} ms" for p, ms in
                                  parts.items()), flush=True)
            torch.cuda.empty_cache()
        print(f"K19 rows torch.sort(owner, stable=True): "
              f"{time_ms(lambda: torch.sort(own, stable=True)):.4f} ms",
              flush=True)
        del rows, owner, valid, own
        torch.cuda.empty_cache()
        # hashed int64 keys, the rows the keys themselves, two-way
        Qk = int(283_360_392 * args.scale)
        keys = torch.randint(0, 2**62, (Qk,), generator=gen,
                             dtype=torch.int64, device=dev)
        krows = keys.view(torch.int32).reshape(-1, 2)
        a = (krows, 4, Qk, None, keys, False, None, True)
        outs = {t: k19[t].run(*a) for t in tags}
        same = len(tags) == 1 or equal(outs["new"], outs["old"])
        print(f"K19 keys: {Qk} int64 keys hashed to 4 owners, two-way: "
              f"outputs equal {same}", flush=True)
        del outs
        for t in turns:
            parts = k19[t].split(*a)
            print(f"K19 keys two-way {t}: " + ", ".join(
                f"{p} {ms:.4f} ms" for p, ms in parts.items()), flush=True)
        from sage2_tpu_torch.kernels import plain
        hown = plain.owner_hash(keys, 4).to(torch.int32)
        print(f"K19 keys torch.sort(owner, stable=True): "
              f"{time_ms(lambda: torch.sort(hown, stable=True)):.4f} ms",
              flush=True)
        del keys, krows, hown
        torch.cuda.empty_cache()

    if args.only in (None, "k21"):
        k21 = {t: K21(libs[t, "reduce_requests"], t) for t in tags}
        g = graph_inputs(gen, args.scale)
        R = g["req"].shape[0]
        print(f"K21 graph: v_d {g['v_d']}, {g['E']} edges padded to "
              f"{g['src'].numel()}, {R} requests", flush=True)
        outs = {}
        for t in tags:
            parts, st = k21[t].steps(g, 2**62)
            for _, fn in parts:
                fn()
            outs[t] = st
        print(f"K21 expand: {outs['new']['total']} candidates", flush=True)
        same = len(tags) == 1 or all(torch.equal(outs["new"][k],
                                                 outs["old"][k])
                                     for k in ("cand", "ok", "counts"))
        print(f"K21 phase 2 outputs equal {same}", flush=True)
        cand = outs["new"]["cand"]
        lens = torch.randint(75, 151, (g["v_d"],), generator=gen,
                             dtype=torch.int32, device=dev)
        marks = {}
        for t in tags:
            fn, removed = k21[t].probe(g, cand, outs[t])
            fn()
            marks[t] = removed
        print(f"K21 probe: {int(marks['new'].sum())} edges marked, equal "
              f"{len(tags) == 1 or torch.equal(marks['new'], marks['old'])}",
              flush=True)
        for t in turns:
            parts, st = k21[t].steps(g, 2**62)
            out = split_ms(parts)
            fn, _ = k21[t].probe(g, cand, st)
            out["probe"] = time_ms(fn)
            fn, _ = k21[t].probe(g, cand, st, lens)
            out["probe ragged"] = time_ms(fn)
            print(f"K21 {t} ({'row table' if k21[t].new else 'whole-array searches'}): "
                  + ", ".join(f"{p} {ms:.4f} ms" for p, ms in out.items()),
                  flush=True)
            del st
            torch.cuda.empty_cache()
        # the table against its plain version and its library call
        from sage2_tpu_torch.kernels import plain
        want = plain.reduce_rows(g["ss_key"], g["vbase"], g["v_d"])
        firsts = (torch.arange(g["v_d"] + 1, device=dev) + g["vbase"]) << 32
        library = lambda: torch.searchsorted(g["ss_key"], firsts)  # noqa
        rows_launch = dict(k21["new"].steps(g, 2**62)[0])["rows"]
        print(f"K21 rows: equal to plain.reduce_rows "
              f"{torch.equal(outs['new']['row'], want)}, torch.searchsorted "
              f"{time_ms(library):.4f} ms; device times behind a spin: the "
              f"launch {device_ms(rows_launch):.4f} ms, torch.searchsorted "
              f"{device_ms(library):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
