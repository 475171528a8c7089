"""The op-stream analyzer (``repro_torch.launch.op_analysis``), the
port's counterpart of ``repro.launch.hlo_analysis``, on programs whose
counts are known: the reference's own oracle cases (a matmul under a
12-step loop, nested 5x7 loops, one unrolled product) counted exactly,
the weighing of traces at a few depths, the bytes rules, the
microbatch regions, the peak, and collectives on a fake group and on a
real gloo group of two processes."""

import json
import os
import subprocess
import sys
import textwrap
from fractions import Fraction

import pytest
import torch

from repro_torch.launch import cells
from repro_torch.launch import op_analysis as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loop_matmul_flops_counted_per_iteration():
    L, d = 12, 32

    def f(ws, x):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return x

    _, t = A.analyze_trace(f, torch.zeros(L, d, d), torch.zeros(4, d))
    assert t.cost.flops == L * 2 * 4 * d * d


def test_nested_loops_multiply():
    lo, li, d = 5, 7, 16

    def f(x):
        for _ in range(lo):
            for _ in range(li):
                x = x @ torch.eye(d)
        return x

    _, t = A.analyze_trace(f, torch.zeros(2, d))
    assert t.cost.flops == lo * li * 2 * 2 * d * d


def test_unrolled_matmul_exact():
    _, t = A.analyze_trace(lambda a, b: a @ b, torch.zeros(8, 24),
                           torch.zeros(24, 40))
    assert t.cost.flops == 2 * 8 * 24 * 40
    assert t.cost.hbm_bytes == 8 * 40 * 4          # its result, f32


def _layered(n):
    """A program of ``n`` alike layers, a head and an update of the
    stacked weights, as a fake-tensor trace sees a model."""
    def f(ws, head, x):
        for i in range(n):
            x = torch.relu(x @ ws[i]) + x
        ws.mul_(0.5)
        return (x @ head).sum()
    return f, (torch.zeros(n, 16, 16), torch.zeros(16, 8),
               torch.zeros(3, 16))


def test_weighing_one_and_two_layers_equals_the_whole():
    def trace(n):
        fn, args = _layered(n)
        return A.analyze_trace(fn, *args)[1].cost
    costs = [trace(n) for n in (1, 2)]
    w = A.depth_weights([{"layer": 1}, {"layer": 2}], {"layer": 12})
    assert w == [Fraction(-10), Fraction(11)]
    whole = trace(12)
    assert A.weigh(costs, w).as_dict() == whole.as_dict()


def test_depth_weights_need_a_depth_a_kind():
    with pytest.raises(ValueError, match="need 3"):
        A.depth_weights([{"a": 1, "b": 1}, {"a": 2, "b": 1}],
                        {"a": 4, "b": 4})
    with pytest.raises(ValueError, match="do not determine"):
        A.depth_weights([{"a": 1, "b": 1}, {"a": 2, "b": 2},
                         {"a": 3, "b": 3}], {"a": 4, "b": 5})
    with pytest.raises(ValueError, match="not affine"):
        A.weigh([A.OpCost(flops=1), A.OpCost(flops=2)],
                [Fraction(1, 2), Fraction(0)])


def test_bytes_rules():
    """New buffers count their bytes; views count 0; a write into a view
    counts the view; a scatter counts its rows; ``out=`` counts out."""
    cache = torch.zeros(4, 100, 8)
    new = torch.ones(4, 2, 8)

    def f(cache, new):
        v = cache.narrow(1, 10, 2).view(4, 16)      # views: 0
        cache[:, 10:12].copy_(new)                   # the slice: 4*2*8*4
        cache[torch.arange(4), 5] = new[:, 0]        # arange (4*8) + rows
        torch.where(cache > 0, cache, new[:1, :1], out=cache)  # bool + cache
        return v

    _, t = A.analyze_trace(f, cache, new)
    whole = 4 * 100 * 8
    assert t.cost.hbm_bytes == (4 * 2 * 8 * 4 + 4 * 8 + 4 * 8 * 4
                                + whole + whole * 4)


def test_inference_mode_counts_the_decomposed_ops():
    """Outside autograd an einsum reaches the counter whole; it counts
    the products it decomposes into, as under autograd."""
    a, b = torch.zeros(2, 3, 5), torch.zeros(2, 5, 7)
    f = lambda a, b: torch.einsum("bij,bjk->bik", a, b)
    with torch.inference_mode():
        _, t = A.analyze_trace(f, a, b)
    _, g = A.analyze_trace(f, a, b)
    assert t.cost.flops == g.cost.flops == 2 * 2 * 3 * 5 * 7


def test_microbatch_regions_are_counted_apart():
    def f(x):
        for _ in range(2):
            with torch.profiler.record_function("microbatch"):
                with torch.profiler.record_function("inner"):
                    x = x @ x
        return x @ x

    _, t = A.analyze_trace(f, torch.zeros(4, 4))
    assert [r.flops for r in t.regions] == [128, 128]
    assert t.cost.flops == 3 * 128


def test_peak_live_bytes():
    def f(x):
        a = x * 2                       # 400 B live beside x
        b = a + 1                       # 800
        del a
        return b * 3                    # 800 again: peak 1200 with x
    _, t = A.analyze_trace(f, torch.zeros(100))
    assert t.argument_bytes == 400
    assert t.peak_bytes == 1200
    assert t.output_bytes == 400


def test_collectives_on_a_fake_group():
    """A fake group's collectives move nothing and are counted by their
    result buffers: an all-reduce its tensor, an all-gather the
    gathered parts, a broadcast its tensor."""
    from repro_torch.dist import collectives as col
    x = torch.zeros(4, 8)
    with cells.dry_group("data=4", device="cpu") as live:
        _, t = A.analyze_trace(lambda x: (col.all_reduce(x, ("data",), live),
                                          col.all_gather(x, ("data",), live),
                                          col.broadcast(x, ("data",), live,
                                                        0)), x)
    c = t.cost.collective_bytes
    assert c["all-reduce"] == c["broadcast"] == 4 * 8 * 4
    assert c["all-gather"] == 4 * 4 * 8 * 4
    assert t.cost.collective_total == 6 * 4 * 8 * 4


_PROGRAM = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives as col
    from repro_torch.dist.mesh import MeshSpec
    from repro_torch.launch import cells, op_analysis as A

    def program(x, live):
        y = col.all_reduce(x @ x, ("data",), live)
        z = col.all_gather(y, ("data",), live, dim=0)
        col.all_reduce_(z, ("data",), live)
        return col.broadcast(z.sum(0), ("data",), live, 1)

    backend, rank, init, out = sys.argv[1:5]
    x = torch.ones(8, 8)
    if backend == "fake":
        with cells.dry_group("data=2", int(rank), "cpu") as live:
            _, t = A.analyze_trace(program, x, live)
    else:
        dist.init_process_group("gloo", init_method=init, rank=int(rank),
                                world_size=2)
        live = col.LiveMesh(MeshSpec.parse("data=2"), torch.device("cpu"))
        _, t = A.analyze_trace(program, x, live)
        col.destroy_process_group()
    json.dump(t.cost.as_dict(), open(out, "w"))
""")


def test_gloo_group_counts_what_the_fake_group_counts(tmp_path):
    """The same program on two gloo ranks (each its own process) and at
    rank 0 of a fake group of two counts the same bytes."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROGRAM, "gloo", str(r), init,
         str(tmp_path / f"gloo{r}.json")], cwd=ROOT) for r in (0, 1)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _PROGRAM, "fake", "0", "",
         str(tmp_path / "fake.json")], cwd=ROOT))
    try:
        assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = {n: json.loads((tmp_path / f"{n}.json").read_text())
           for n in ("gloo0", "gloo1", "fake")}
    assert got["gloo0"] == got["gloo1"] == got["fake"]
    assert got["fake"]["collective_bytes"] == {
        "all-gather": 2 * 8 * 8 * 4, "all-reduce": 8 * 8 * 4 + 16 * 8 * 4,
        "reduce-scatter": 0, "all-to-all": 0, "broadcast": 8 * 4,
        "total": 8 * 8 * 4 + 2 * 16 * 8 * 4 + 8 * 4}
