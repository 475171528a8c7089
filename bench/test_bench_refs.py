"""The plain references against the port at small sizes, on the CPU: the
dense decoder at minicpm-2b's SMOKE widths, VGG19's topology at 1/8 of
its widths and 32x32.  The test imports both sides; the references
import nothing of the program."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import repro_torch  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import ModelBuilder  # noqa: E402

from bench import run  # noqa: E402
from bench.systems.graph_infer import build_graph  # noqa: E402
from bench.refs import decoder, vgg  # noqa: E402

SMOKE = {"name": "minicpm-2b-smoke", "family": "dense", "num_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
         "vocab": 256, "head_dim": 16, "rope_theta": 1e4, "mlp_act": "silu",
         "tie_embeddings": True, "scale_embed": True, "lr_schedule": "wsd",
         "q_chunk": 16, "kv_chunk": 32, "dtype": "float32"}


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_decoder_reference_matches_the_port(seed):
    cpu = torch.device("cpu")
    w = decoder.make_weights(SMOKE, seed, cpu, torch.float32)
    exe = repro_torch.compile(ArchConfig(**SMOKE), repro_torch.CompileOptions(
        target="engine", device="cpu"), params=decoder.make_weights(
            SMOKE, seed, cpu, torch.float32))
    toks = torch.randint(0, SMOKE["vocab"], (70,),
                         generator=torch.Generator().manual_seed(seed))
    got = exe(tokens=toks[None].int())["logits"][0].float()
    with decoder.full_f32():
        ref = decoder.logits(SMOKE, w, toks, torch.arange(70))
    assert (got - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max())


def test_vgg_reference_matches_the_port():
    cfg = dict(run.load_json(run.HERE / "configs" / "vgg19.json"),
               input=[32, 32, 3],
               blocks=[[8, 2], [16, 2], [32, 4], [64, 4], [64, 4]],
               dense=[512, 512, 1000])
    w = vgg.make_weights(cfg, 9, torch.device("cpu"))
    host = [(k, a.numpy(), b.numpy()) for k, a, b in w]
    exe = repro_torch.compile(build_graph(ModelBuilder, cfg, host),
                              repro_torch.CompileOptions(device="cpu",
                                                         **cfg["compile"]))
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    got = next(iter(exe(input=x).values()))
    ref = vgg.forward(cfg, w, x)
    assert got.shape == ref.shape == (3, 1000)
    assert vgg.max_log_error(got, ref) <= 1e-4


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import bench.refs.decoder, bench.refs.vgg, bench.generator, "
            "bench.counts, bench.stats, bench.trace; "
            "from pathlib import Path; "
            "[bench.generator.kind({'kind': p.stem}) for p in "
            "(Path(bench.generator.HERE) / 'kinds').glob('*.py')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
