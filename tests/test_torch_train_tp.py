"""The mesh train step with its compute split over ``model``, as the
reference's constraints split it (``heads``, ``kv_heads``, ``mlp``,
``vocab`` on ``model``): gloo groups on the CPU
(``tests/_train_mesh_worker.py``, ``TP_CASES``), without ``tp_psum``, so
the row-parallel sums run in f32.

* every SMOKE config on ``model=2``; qwen2.5-14b, deepseek-v3-671b,
  whisper-base and recurrentgemma-9b on ``data=2,model=2``; and an
  uneven split on ``model=4`` (qwen2.5-14b SMOKE with 6 heads over 2 KV
  heads, vocab 250 and MLP width 130: head ranges of 2, 1, 2, 1, each KV
  head computed on two ranks, vocab rows and MLP columns in ranges of
  unequal size), and whisper-base with 2 heads on ``model=4`` (fewer
  heads than ranks: every rank computes them whole).  Three f32 steps each against the one-device step
  under the limits of ``test_torch_train_mesh.py`` (loss within 1e-5 x
  max(1, |loss|), each gradient leaf within 1e-4 x max(1, max|g|),
  ``grad_norm`` within 1e-5 relative), and the state bit-equal across
  the ranks that hold the same part;
* the leaves compute cuts (``step.cut_leaves``) are exactly those whose
  logical axes name ``heads``, ``kv_heads``, ``mlp``, ``vocab`` or
  ``experts`` (mamba2: its tied embedding alone, the mixer stays whole),
  never a norm or the router; those whose range is the rank's equal part
  are held as that part (not gathered over ``model``), the rest gathered
  whole and sliced;
* the split rule (``sharding.unit_range``): ranges in order cover
  ``[0, n)``, rank 0 holds ⌈n/k⌉, the most, and where ``k`` divides
  ``n`` each range is ``part_of``'s part; the uneven gather of ranges
  and the max over ``model`` against the one-process computation.

The three groups run at once.
"""

import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _train_mesh_worker as W
from test_torch_train_mesh import (check_against_one_device,
                                   check_replicas_bit_equal)

MESHES = ("model=2", "data=2,model=2", "model=4")
NAMES = {m: [n for n, c in W.TP_CASES.items() if c[0] == m] for m in MESHES}
CASES = [(m, n) for m, names in NAMES.items() for n in names]
#: The logical axes whose dims compute splits over ``model``.
SPLIT_AXES = {"heads", "kv_heads", "mlp", "vocab", "experts"}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    dirs = {m: tmp_path_factory.mktemp(m.replace(",", "_").replace("=", ""))
            for m in MESHES}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        for f in [pool.submit(W.spawn_group, m, W.GROUPS[m], str(dirs[m]),
                              NAMES[m]) for m in MESHES]:
            f.result()
    return {m: [json.load(open(dirs[m] / f"{r}.json"))
                for r in range(W.GROUPS[m])] for m in MESHES}


@pytest.mark.parametrize("mesh,name", CASES)
def test_split_step_matches_one_device(groups, mesh, name):
    for res in groups[mesh]:
        check_against_one_device(res[name])


@pytest.mark.parametrize("mesh,name", CASES)
def test_split_state_bit_equal_across_ranks(groups, mesh, name):
    check_replicas_bit_equal([res[name] for res in groups[mesh]])


def model_ranks(mesh: str) -> int:
    """The size of ``mesh``'s ``model`` axis (``"data=2,model=2"``: 2)."""
    return int(dict(a.split("=") for a in mesh.split(",")).get("model", 1))


def _expected_cuts(arch, over, k):
    """The param paths whose logical axes name a split axis (mamba2: its
    embedding alone; with fewer heads than the ``k`` ranks, the heads'
    weights are whole)."""
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten
    if arch == "mamba2-780m":
        return ["embed"]
    cfg = W.config(arch, **over)
    split = SPLIT_AXES - ({"heads", "kv_heads"} if cfg.n_heads < k else set())
    axes = get_model(cfg).param_axes()
    return sorted(p for p, ax in tree_flatten(axes) if split & set(ax))


@pytest.mark.parametrize("mesh,name", CASES)
def test_split_leaves_are_the_constrained_weights(groups, mesh, name):
    _, arch, over, _, _ = W.CASES[name]
    want = _expected_cuts(arch, over, model_ranks(mesh))
    for res in groups[mesh]:
        got = res[name]["cut"]
        assert sorted(got) == want, (sorted(set(got) ^ set(want)))
        assert not any(k in p for p in got
                       for k in ("ln", "norm", "router")), got
        held = set(res[name]["held"])
        if name.startswith("tp_model4_uneven"):
            # no range is an equal part: every cut leaf gathered whole
            assert not held, held
            continue
        # the KV heads of recurrentgemma (one, on every rank) are whole
        whole = {p for p in got if arch == "recurrentgemma-9b"
                 and p.endswith(("/wk", "/wv"))}
        assert held == set(got) - whole, (held ^ (set(got) - whole))
        for path in held:
            assert "model" in res[name]["cut_axes"]["params/" + path], path


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fn", ["gather_part", "all_max", "copy_to_model",
                                "reduce_from_model"])
def test_split_collectives(groups, mesh, fn):
    for res in groups[mesh]:
        assert res["collectives"][fn], (mesh, fn)


class _Mesh:
    """A stand-in for ``LiveMesh.split`` on one axis."""

    def __init__(self, k, i):
        self.k, self.i = k, i

    def split(self, axes):
        return self.k, self.i


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 16])
def test_split_rule(k):
    from repro_torch.distributed.sharding import Part, part_of, unit_range
    for n in list(range(1, 41)) + [122753, 152064]:
        ranges = [unit_range(n, k, i) for i in range(k)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert sizes[0] == math.ceil(n / k) == max(sizes)
        assert min(sizes) >= max(sizes) - 1
        whole = np.arange(n)
        for i, (lo, hi) in enumerate(ranges):
            even = Part(lo, hi, n, k, i).even
            assert even == (n % k == 0), (n, k, i)
            if n % k == 0:
                got = part_of(whole, [(0, ("model",))], _Mesh(k, i))
                assert np.array_equal(got, whole[lo:hi]), (n, k, i)
