"""K2's compacted L1-miss stream and request buckets, in plain torch.

``cluster_scan.miss_stream_plain`` and ``request_buckets_plain`` are the
plain versions of what K2 (``csrc/cluster_scan.cu``) builds before its L2
walk: each K1b lane's misses in (row, site) order, and each K2 lane's
candidates (its cores' misses in the reference's (row, rank, site) order)
with the requests among them bucketed by L2 set.  Here they are held
against a separate, dense expansion of K1b's plain accesses and outcomes
(``engine_scan.l1_accesses`` and ``l1_outcomes``, walked whole): a (lane,
row, site) table of missed lines, gathered per row and rank.  Both kinds
of K1b lanes are covered: shared by a program's cores (each core's lines
its shift of core 0's), and one per core where the shift leaves the int32
range.  Then the composed split (K1's plain halves and
``cluster_l2_plain``) is held to the reference's ``simulate_cluster_grid``
through the port's ``simulate_cluster_grid``.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import cluster as jcl  # noqa: E402
from repro import rvv as jrvv  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch import cluster as tcl  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.cluster.engine import _stride  # noqa: E402
from repro_torch.core import policies  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.kernels import cluster_scan as k2  # noqa: E402
from repro_torch.kernels import engine_scan as k1  # noqa: E402

CORES = (1, 2, 4, 8)
# The shared memories chip_smoke's [cluster] checks K2 behind (its
# _check_clusters): the default, the passthrough, no L2 on two channels,
# the suites' 256 x 4 L2 on two channels, an odd 32 x 3 on three
MEMORIES = {
    "default": lambda n: tcl.ClusterConfig(n_cores=n),
    "passthrough": tcl.ClusterConfig.passthrough,
    "no_l2": lambda n: tcl.ClusterConfig(n_cores=n, l2_sets=0,
                                         mem_channels=2),
    "l2_256x4": lambda n: tcl.ClusterConfig(n_cores=n, l2_sets=256,
                                            l2_ways=4, mem_channels=2),
    "l2_32x3": lambda n: tcl.ClusterConfig(n_cores=n, l2_sets=32,
                                           l2_ways=3, mem_channels=3)}
CLUSTERS = [(mem, n, make(n)) for n in CORES for mem, make in
            MEMORIES.items()]
L1_SETS, L1_WAYS = 16, 2
SHARED, PER_CORE = 0, 1          # the programs: gemv as it is, dropout moved


@pytest.fixture(scope="module")
def split():
    """gemv (shared K1b lanes) and dropout with its spill region moved so
    that a shift by up to 7 strides leaves the int32 range (one K1b lane
    per core), capacities 3 (a cVRF lane: 8 sites) and 32 (the full VRF:
    MEM only), every cluster point in one plan; K1's plain halves with
    K1b's accesses kept, and K2's plain stream and buckets."""
    ps = []
    for name in ("gemv", "dropout"):
        b = trvv.BENCHMARKS[name]
        ps.append(tsim.prepare(b.build(**b.reduced_params).program))
    arrays, spill0s = tsim._stack(ps)
    x = k1.pack(arrays)
    sp0 = torch.as_tensor(spill0s).clone()
    strides = [_stride(p) for p in ps]
    sp0[PER_CORE] = 2 ** 31 - 3 * strides[PER_CORE] - 20
    lengths = [p.num_rows for p in ps]
    sweep = tsim.SweepConfig.product((3, 32), (policies.FIFO,), (False,))
    cfg = (sweep.capacity, sweep.policy, sweep.alloc_no_fetch)
    mach = (np.int32([1]), np.int32([1]), np.int32([5]))
    invariant = k2.address_invariant(x, sp0, strides, lengths, max(CORES))
    assert invariant == [True, False]
    plan = k2.cluster_scan_plan(
        L1_SETS, L1_WAYS, lengths, cfg, [c for *_, c in CLUSTERS],
        strides=strides, invariant=invariant, T=x.shape[1])
    (g,) = plan["groups"]
    prog, k = map(list, zip(*g["reg_lanes"]))
    stream, reg_ctr = k1.engine_reg_plain(
        x, prog, tuple(np.asarray(a)[k] for a in cfg), track_ab=False,
        lengths=lengths)
    l1_prog, _, l1_reg, l1_base = map(list, zip(*g["l1_lanes"]))
    _, keep = k1.engine_l1_plain(
        x, sp0, stream, reg_ctr, l1_prog, l1_reg,
        [j for *_, j in g["k1_outputs"]], mach, l1_sets=L1_SETS,
        l1_ways=L1_WAYS, track_ab=False, lengths=lengths, l1_base=l1_base,
        keep=True)
    misses = k2.miss_stream_plain(keep, g, lengths)
    cands = k2.request_buckets_plain(misses, g, [
        k2._cluster(c) for *_, c in CLUSTERS])
    return dict(x=x, sp0=sp0, stream=stream, lengths=lengths, group=g,
                misses=misses, cands=cands, dense=_dense(
                    x, sp0, stream, g, lengths))


def _dense(x, sp0, stream, group, lengths):
    """(L, T, 8) missed lines and their flags per (K1b lane, row, site),
    from K1b's plain accesses walked whole through each lane's L1."""
    l1_prog, _, l1_reg, l1_base = map(list, zip(*group["l1_lanes"]))
    lane, row, site, line, write = k1.l1_accesses(
        x, sp0, stream, l1_prog, l1_reg, lengths, l1_base)
    miss, _ = k1.l1_outcomes(lane, line, write, k1._stamp(row, site),
                             len(l1_prog), L1_SETS, L1_WAYS, by_set=False)
    shape = (len(l1_prog), x.shape[1], k1.SITES)
    flag = np.zeros(shape, bool)
    lines = np.zeros(shape, np.int64)
    at = (lane[miss].numpy(), row[miss].numpy(), site[miss].numpy())
    flag[at] = True
    lines[at] = line[miss].numpy()
    return flag, lines


def _wrap(v):
    return (np.asarray(v, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _expand(split, kl):
    """K2 lane kl's candidates by the dense table: rank r of row t is core
    (t mod N + r) mod N, read at (its K1b lane, t, site) and shifted by
    its shift; (row, rank, line) in (row, rank, site) order."""
    flag, lines = split["dense"]
    p, _, i, l1s, shifts = split["group"]["k2_lanes"][kl]
    n = CLUSTERS[i][2].n_cores
    T = split["lengths"][p]
    t = np.arange(T)[:, None]
    core = (t % n + np.arange(n)[None, :]) % n                   # (T, n)
    j = np.asarray(l1s)[core]
    tt = np.broadcast_to(t, core.shape)
    has = flag[j, tt]                                            # (T, n, 8)
    line = _wrap(lines[j, tt] + np.asarray(shifts)[core][..., None])
    rows = np.broadcast_to(t[:, :, None], has.shape)
    ranks = np.broadcast_to(np.arange(n)[None, :, None], has.shape)
    return rows[has], ranks[has], line[has]


def _kind(split, kl):
    return "shared" if split["group"]["k2_lanes"][kl][0] == SHARED \
        else "per_core"


@pytest.mark.parametrize("kind", ["shared", "per_core"])
def test_miss_stream_is_each_lanes_misses_in_row_site_order(split, kind):
    flag, lines = split["dense"]
    ms = split["misses"]
    seen = 0
    for j, (p, *_) in enumerate(split["group"]["l1_lanes"]):
        if (p == SHARED) != (kind == "shared"):
            continue
        T = split["lengths"][p]
        row, site = np.nonzero(flag[j, :T])
        a, b = (int(ms["row_off"][ms["row0"][i]]) for i in (j, j + 1))
        np.testing.assert_array_equal(ms["row"][a:b].numpy(), row)
        np.testing.assert_array_equal(ms["site"][a:b].numpy(), site)
        np.testing.assert_array_equal(ms["line"][a:b].numpy(),
                                      lines[j, row, site])
        counts = flag[j, :T].sum(axis=1)
        np.testing.assert_array_equal(
            np.diff(ms["row_off"][ms["row0"][j]:ms["row0"][j + 1] + 1]
                    .numpy()), counts)
        np.testing.assert_array_equal(
            ms["row_mask"][ms["row0"][j]:ms["row0"][j + 1]].numpy(),
            (flag[j, :T] << np.arange(k1.SITES)).sum(axis=1))
        np.testing.assert_array_equal(ms["row_misses"][a:b].numpy(),
                                      counts[row])
        first = np.concatenate([[0], np.cumsum(counts)])[row]
        np.testing.assert_array_equal(ms["place"][a:b].numpy(),
                                      np.arange(b - a) - first)
        seen += b - a
    assert seen > 0


@pytest.mark.parametrize("n", CORES)
@pytest.mark.parametrize("kind", ["shared", "per_core"])
def test_candidates_are_the_cores_misses_in_row_rank_site_order(split, kind,
                                                                n):
    cands = split["cands"]
    base = cands["cand_base"]
    lanes = [kl for kl, (_, _, i, _, _) in enumerate(
        split["group"]["k2_lanes"])
        if CLUSTERS[i][1] == n and _kind(split, kl) == kind]
    assert lanes
    for kl in lanes:
        row, rank, line = _expand(split, kl)
        at = slice(base[kl], base[kl + 1])
        np.testing.assert_array_equal(cands["row"][at].numpy(), row)
        np.testing.assert_array_equal(cands["rank"][at].numpy(), rank)
        np.testing.assert_array_equal(cands["line"][at].numpy(), line)
        np.testing.assert_array_equal(cands["on"][at].numpy(), line >= 0)
    if kind == "per_core" and n == max(CORES):
        # cores 4..7's spill regions wrap past 2^31: some are no request
        assert not all(bool(cands["on"][base[kl]:base[kl + 1]].all())
                       for kl in lanes)


@pytest.mark.parametrize("memory", list(MEMORIES))
@pytest.mark.parametrize("kind", ["shared", "per_core"])
def test_request_buckets_are_the_requests_by_set_in_order(split, kind,
                                                          memory):
    cands = split["cands"]
    base, starts = cands["cand_base"], cands["bucket_start"]
    # the buckets follow each other lane by lane and set by set
    at = 0
    for kl, (_, _, i, _, _) in enumerate(split["group"]["k2_lanes"]):
        sets = CLUSTERS[i][2].l2_sets
        if not sets:
            assert starts[kl].numel() == 0
            continue
        assert int(starts[kl][0]) == at
        at = int(starts[kl][-1])
        if CLUSTERS[i][0] != memory or _kind(split, kl) != kind:
            continue
        _, _, line = _expand(split, kl)
        cand = base[kl] + np.nonzero(line >= 0)[0]
        req = line[line >= 0]
        for s in range(sets):
            mine = req % sets == s
            lo, hi = (int(v) for v in starts[kl][s:s + 2])
            np.testing.assert_array_equal(cands["req_line"][lo:hi].numpy(),
                                          req[mine])
            np.testing.assert_array_equal(cands["req_cand"][lo:hi].numpy(),
                                          cand[mine])
    assert at == cands["req_line"].numel()


def test_each_lane_counts_every_core_miss_once(split):
    g, ms = split["group"], split["misses"]
    per_lane = [int(ms["row_off"][ms["row0"][j + 1]]
                    - ms["row_off"][ms["row0"][j]])
                for j in range(len(g["l1_lanes"]))]
    base = split["cands"]["cand_base"]
    for kl, (_, _, _, l1s, _) in enumerate(g["k2_lanes"]):
        assert base[kl + 1] - base[kl] == sum(per_lane[j] for j in l1s)


def _c_params(entry: str) -> list:
    src = (Path(k2.__file__).resolve().parent / "csrc" / "cluster_scan.cu")
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                     src.read_text())
    return [p.split()[-1].lstrip("*") for p in decl.group(1).split(",")]


def _fake_l2_launch(monkeypatch, split, mem=(5, 9), lengths=None):
    """cluster_l2_cuda on the split's group with its launch faked on the
    CPU: every argument the C entry point would get, by its parameter's
    name, and the lane arrays read back at their pointers
    (``launches``, one dict a call), and the call's outputs."""
    g = split["group"]
    lengths = split["lengths"] if lengths is None else lengths
    launches = []

    def launch(x, entry, *args, library=None):
        assert entry == "cluster_l2_launch"
        a = dict(zip(_c_params(entry), args))
        K, Q, L, M = a["K"], a["Q"], a["L"], a["M"]

        def ints(name, n):
            return np.ctypeslib.as_array(
                (ctypes.c_int * n).from_address(a[name])).copy()
        launches.append(dict(a, arrays={name: ints(name, n) for name, n in (
            ("lengths", len(split["lengths"])), ("l1_row0", L + 1),
            ("k_prog", K), ("k_cores", K), ("k_sets", K), ("k_ways", K),
            ("k_chan", K), ("k_hit", K), ("k_l1", 8 * K),
            ("k_shift", 8 * K), ("o_lane", Q), ("o_k1", 8 * Q),
            ("mem", M))}))

    monkeypatch.setattr(k2, "_launch", launch)
    monkeypatch.setattr(k2, "_rows_on_card", lambda x, who: x)
    slots = [0] + np.cumsum([split["lengths"][p] * (k1.SITES if r >= 0
                                                    else 2)
                             for p, _, r, _ in g["l1_lanes"]]).tolist()
    keep = dict(recs=torch.zeros((slots[-1], 2), dtype=torch.int32),
                outcome=torch.zeros(slots[-1], dtype=torch.uint8),
                hist=torch.zeros(8, dtype=torch.int32), tiles=1, slots=slots)
    Q1 = len(g["k1_outputs"])
    outs = k2.cluster_l2_cuda(
        split["x"], keep, g, [torch.zeros((Q1, len(mem), 12),
                                          dtype=torch.int32)] * 3,
        (np.int32([1] * len(mem)), np.int32([1] * len(mem)), np.int32(mem)),
        [k2._cluster(c) for *_, c in CLUSTERS], l1_sets=L1_SETS,
        track_ab=False, lengths=lengths)
    return launches, outs, slots


def test_launch_reads_each_lane_array_at_its_pointer(monkeypatch, split):
    """cluster_l2_cuda moves the lanes' arrays to the card as one int32
    tensor: with the launch faked on the CPU, every pointer the C entry
    point gets must read back the array its parameter names, and the
    sizes the buffers' bounds."""
    g, lengths = split["group"], split["lengths"]
    (got,), outs, slots = _fake_l2_launch(monkeypatch, split)
    clusters = [k2._cluster(c) for *_, c in CLUSTERS]
    arrays = got["arrays"]
    lanes, outputs = g["k2_lanes"], g["k2_outputs"]
    cl = [clusters[i] for _, _, i, _, _ in lanes]
    np.testing.assert_array_equal(arrays["lengths"], lengths)
    np.testing.assert_array_equal(arrays["l1_row0"], np.cumsum(
        [0] + [lengths[p] for p, *_ in g["l1_lanes"]]))
    for col, name in enumerate(("k_cores", "k_sets", "k_ways", "k_chan",
                                "k_hit")):
        np.testing.assert_array_equal(arrays[name], [c[col] for c in cl])
    np.testing.assert_array_equal(arrays["k_prog"], [v[0] for v in lanes])
    for name, at in (("k_l1", 3), ("k_shift", 4)):
        np.testing.assert_array_equal(
            arrays[name].reshape(-1, 8),
            [list(v[at]) + [0] * (8 - len(v[at])) for v in lanes])
    np.testing.assert_array_equal(arrays["o_lane"], [o[3] for o in outputs])
    np.testing.assert_array_equal(
        arrays["o_k1"].reshape(-1, 8),
        [list(o[4]) + [0] * (8 - len(o[4])) for o in outputs])
    np.testing.assert_array_equal(arrays["mem"], [5, 9])
    bound = [c[0] * lengths[v[0]] * (k1.SITES if g["l1_lanes"][v[3][0]][2]
                                     >= 0 else 2) for v, c in zip(lanes, cl)]
    assert got["candidates"] == sum(bound)
    assert got["tiles"] == sum(-(-b // k2.K2_TILE_CANDIDATES) for b in bound)
    assert got["row_slots"] == sum(lengths[p] for p, *_ in g["l1_lanes"])
    assert got["records"] == slots[-1]
    assert [tuple(o.shape) for o in outs] == [
        (len(outputs), 2, k2.MAX_CORES, k2.CLUSTER_COUNTERS)] * 3


def test_launch_reuses_its_plans_table_and_checks_lengths(monkeypatch,
                                                         split):
    """A second launch on the same plan and machines reads the same copy
    of the lanes' arrays; other machines get a copy of their own, with
    their latencies; lengths other than the plan's are refused."""
    split["group"]["k2_table"].pop("on", None)
    first, _, _ = _fake_l2_launch(monkeypatch, split)
    again, _, _ = _fake_l2_launch(monkeypatch, split)
    other, _, _ = _fake_l2_launch(monkeypatch, split, mem=(7, 11, 13))
    assert again[0]["lengths"] == first[0]["lengths"]
    assert other[0]["lengths"] != first[0]["lengths"]
    np.testing.assert_array_equal(other[0]["arrays"]["mem"], [7, 11, 13])
    np.testing.assert_array_equal(other[0]["arrays"]["k_l1"],
                                  first[0]["arrays"]["k_l1"])
    assert len(split["group"]["k2_table"]["on"]) == 2
    with pytest.raises(ValueError, match="lengths"):
        _fake_l2_launch(monkeypatch, split,
                        lengths=[n + 1 for n in split["lengths"]])


# -- the composed split against the reference ----------------------------------

SPLIT_CASES = [(8, "l2_256x4", True), (8, "l2_32x3", False),
               (4, "default", True)]


@pytest.mark.parametrize("n,memory,fold", SPLIT_CASES,
                         ids=lambda v: str(v))
def test_split_equals_the_reference(monkeypatch, n, memory, fold):
    """The port's simulate_cluster_grid with the split (K1's plain halves,
    then cluster_l2_plain over the plain stream and buckets) in place of
    the twin equals the reference's, every key and every per-core
    counter."""
    monkeypatch.setattr(k2, "cluster_scan", k2.cluster_split_plain)
    got, want = [], []
    for out, sim, rvv, cl, kw in (
            (got, tsim, trvv, tcl, dict(device="cpu")),
            (want, jsim, jrvv, jcl, dict(batch_programs=True))):
        preps = []
        for name in ("gemv", "dropout"):
            b = rvv.BENCHMARKS[name]
            p = b.build(**b.reduced_params).program
            preps.append(sim.prepare(p, fold=True, warm_lines=16) if fold
                         else sim.prepare(p))
        sweep = sim.SweepConfig.product((3, 4, 32), (policies.FIFO,
                                                     policies.LRU),
                                        (False,))
        machines = sim.MachineSweep.from_params(
            [sim.MachineParams(mem_latency=m, l1_sets=L1_SETS,
                               l1_ways=L1_WAYS) for m in (5, 9)])
        fields = MEMORIES[memory](n)
        config = cl.ClusterConfig(
            n_cores=n, l2_sets=fields.l2_sets, l2_ways=fields.l2_ways,
            mem_channels=fields.mem_channels,
            l2_hit_cycles=fields.l2_hit_cycles)
        out.append(cl.simulate_cluster_grid(preps, sweep, machines, config,
                                            return_per_core=True, **kw))
    (got,), (want,) = got, want
    assert set(got) == set(want)
    for key in want:
        if key == "per_core":
            continue
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    for key, w in want["per_core"].items():
        np.testing.assert_array_equal(got["per_core"][key], np.asarray(w),
                                      err_msg=key)
