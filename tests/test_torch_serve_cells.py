"""The partitioned serving program (``launch.cells.serve_program``, the
reference's prefill and decode cells) on gloo groups on the CPU
(``tests/_serve_cells_worker.py``).

Each case runs the program's prefill of 4 seeded prompts of 12 tokens,
then 3 greedy decode steps, from params drawn with numpy, against one
device's ``Model.prefill`` and ``Model.decode_step`` on the same params
and prompts:

* every SMOKE config on ``model=2`` and on ``data=2,model=2``, and
  qwen2.5-14b with ``tp_psum`` on both, at f32: the gathered logits of
  every step and the gathered cache within 1e-5 x max(1, max|.|) of one
  device's, and the greedy tokens equal;
* the SMOKE configs at bf16 on ``model=2`` (fed one device's tokens):
  the logits and the cache within 0.05 x max(1, max|.|);
* qwen2.5-14b with ``cache_update="scatter"``, and whisper-base with a
  cache of 15 positions, which ``model=2`` does not divide (its self
  cache is then held by heads);
* qwen2.5-14b split unevenly over ``model=4`` (6 heads over 2 KV heads,
  vocab 250, MLP width 130), with a cache of 16 positions (each rank's
  part filled by an all-to-all of the KV heads) and of 18 (whole on
  every rank, attended with the rank's own heads);
* the params a rank holds are the reference's placement's bytes, and
  an uneven range of a weight placed over ``model`` is gathered from
  the ranks' parts, not whole.

A MoE on a mesh with ``model`` routes each ``batch`` part's rows alone,
as the reference's expert-parallel ``shard_map`` does, so its one-device
twin runs each row part alone.  The reference's own ``lower_cell``
prefill and decode programs, compiled on 4 host devices
(``ORACLE_SCRIPT``), hold the program on ``data=2,model=2`` for
qwen2.5-14b, mixtral-8x22b and whisper-base at f32: the gathered logits
within 1e-5 x max(1, max|logits|) at each step.

The three groups and the oracle run at once.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import _serve_cells_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = tuple(W.GROUPS)
NAMES = {m: [n for n, c in W.CASES.items() if c[0] == m] for m in MESHES}
CASES = [(W.CASES[n][0], n) for n in W.CASES]
F32_LIMIT = 1e-5
BF16_LIMIT = 0.05


def _limit(name):
    return F32_LIMIT if W.CASES[name][3] == "float32" else BF16_LIMIT


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    dirs = {m: tmp_path_factory.mktemp(m.replace(",", "_").replace("=", ""))
            for m in MESHES}
    oracle_dir = tmp_path_factory.mktemp("oracle")

    def run(mesh):
        oracle = None
        if mesh == W.ORACLE_MESH:
            oracle = W.reference_oracle(str(oracle_dir), ROOT)
        W.spawn_group(mesh, W.GROUPS[mesh], str(dirs[mesh]), NAMES[mesh],
                      oracle)

    with ThreadPoolExecutor(len(MESHES)) as pool:
        for f in [pool.submit(run, m) for m in MESHES]:
            f.result()
    return {m: [json.load(open(dirs[m] / f"{r}.json"))
                for r in range(W.GROUPS[m])] for m in MESHES}


@pytest.mark.parametrize("mesh,name", CASES)
def test_logits_match_one_device(groups, mesh, name):
    for rank, res in enumerate(groups[mesh]):
        errs = res[name]["logits_err"]
        assert len(errs) == W.STEPS + 1
        assert max(errs) <= _limit(name), (rank, errs)


@pytest.mark.parametrize("mesh,name", CASES)
def test_cache_matches_one_device(groups, mesh, name):
    for rank, res in enumerate(groups[mesh]):
        assert res[name]["cache_shapes_equal"], rank
        errs = res[name]["cache_err"]
        assert max(errs.values()) <= _limit(name), (rank, errs)


@pytest.mark.parametrize("mesh,name", [c for c in CASES
                                       if W.CASES[c[1]][3] == "float32"])
def test_greedy_tokens_equal(groups, mesh, name):
    for rank, res in enumerate(groups[mesh]):
        assert res[name]["tokens_equal"], rank


@pytest.mark.parametrize("mesh,name", CASES)
def test_params_held_are_the_placed_bytes(groups, mesh, name):
    for res in groups[mesh]:
        got = res[name]
        assert got["param_bytes"] == got["placed_param_bytes"] > 0


@pytest.mark.parametrize("mesh,name", CASES)
def test_uneven_ranges_are_gathered_from_the_parts(groups, mesh, name):
    """A range of heads that is no equal part of a weight placed over
    ``model`` (6 heads on ``model=4``: wq's and wo's columns and rows,
    and the KV heads those ranges read; recurrentgemma-9b's one KV head,
    whose 16 columns the placement halves, read whole by both ranks) is
    gathered from the ranks' parts (``ParamPlan.span``), never gathered
    whole; an even split holds its part."""
    arch = W.CASES[name][1]
    for res in groups[mesh]:
        spans = set(res[name]["spans"])
        if name.startswith("model4_uneven"):
            assert {"layers/attn/wq", "layers/attn/wo", "layers/attn/wk",
                    "layers/attn/wv"} <= spans, spans
        elif arch == "recurrentgemma-9b":
            assert spans == {"blocks/attn/mixer/wk",
                             "blocks/attn/mixer/wv"}, spans
        else:
            assert not spans, spans


@pytest.mark.parametrize("arch", W.ORACLE_ARCHS)
def test_matches_the_reference_cells(groups, arch):
    for rank, res in enumerate(groups[W.ORACLE_MESH]):
        got = res[f"oracle/{arch}"]
        assert len(got["logits_err"]) == W.STEPS + 1
        assert max(got["logits_err"]) <= F32_LIMIT, (rank, got)
