"""The training launcher over two ranks on the CPU (gloo).

* ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train --smoke --device cpu --mesh host`` (the
  reference's 1x2 (data, model) mesh, so the step splits its compute
  over ``model``) logs the losses the mesh step computes and leaves its
  checkpoints, byte for byte, as the launcher's loop written out with
  the library over the same two ranks does
  (``_train_mesh_worker.launcher_twin``); the checkpoint has the layout
  of ``--mesh none``'s on one device (the same files, each leaf whole)
  and restores on one device; the learning rates are one device's, and
  the losses and ``grad_norm`` one device's within one bf16 ulp
  (``BF16_ULP``), and each restored leaf's movement from the initial
  state one device's within ``MOVE_TOL`` of it.  (The split sums the
  bf16 SMOKE config's products in another order than one device, so its
  values are not one device's bits; the f32 steps are held to one device
  bit-tight in ``test_torch_train_tp.py``);
* SIGTERM in the middle of step 5's in-place update, sent to both ranks
  or to rank 1 alone: every rank finishes the step, the ranks agree to
  stop, step 5 is saved (checkpoints 3 and 5) and every rank exits 143;
  resumed to 10 under ``torch.distributed.run``, the logs and the step-9
  checkpoint equal the uninterrupted two-rank run's.
"""

import filecmp
import json
import os
import signal
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _train_mesh_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "minicpm-2b", "--smoke", "--batch", "2", "--seq", "16",
        "--ckpt-every", "3", "--log-every", "1", "--device", "cpu"]
KEYS = ("loss", "lr", "grad_norm")
#: The mesh run's losses and ``grad_norm`` against one device's, relative:
#: one bf16 ulp (2^-7).  The SMOKE config computes in bf16 and the split
#: sums the same products in another order, so an activation may round
#: the other way, by one ulp; a mean over many of them moves by much less
#: than one ulp of its own (measured over the 6 steps: 5.5e-4 for the
#: loss, 1.6e-3 for ``grad_norm`` with its rounding to 3 decimals).
BF16_ULP = 2.0 ** -7
#: Each restored leaf's distance from one device's, over one device's
#: movement from the initial state (L2 norms).  Each step's gradients
#: differ by under one bf16 ulp at their leaf's scale
#: (``test_torch_train_placement.py``); AdamW's m / sqrt(v) magnifies
#: that where a coordinate's gradient is near zero, so over the 6 steps
#: the gap grows to 1.8% (moments) and 6.0% (params) of the movement,
#: measured; a checkpoint of the initial state would be 100%.
MOVE_TOL = 2.0 ** -3
#: The launcher's settings of BASE, for its twin.
TWIN = {"arch": "minicpm-2b", "batch": 2, "seq": 16, "lr": 3e-3,
        "ckpt_every": 3}

#: One rank of the launcher, its update at ``argv[1]`` steps done held
#: after the first leaf is written (``torch.sqrt_`` runs once a leaf)
#: until SIGTERM has arrived, with ``PAUSED <rank>`` printed first; only
#: the ranks listed in ``argv[2]`` pause.
PAUSED_RANK = """
import os, select, signal, sys
import torch
import repro_torch.training.optim as optim
from repro_torch.launch.train import main

pause_at, pausing = int(sys.argv[1]), sys.argv[2].split(",")
rank = os.environ["RANK"]
woken, wake = os.pipe()
os.set_blocking(wake, False)
signal.set_wakeup_fd(wake)
real_update, real_sqrt = optim.adamw_update, torch.sqrt_


def update(cfg, params, grads, opt, inplace=False, **kw):
    if int(opt["step"]) != pause_at or rank not in pausing:
        return real_update(cfg, params, grads, opt, inplace, **kw)
    calls = []

    def sqrt_(t):
        calls.append(1)
        if len(calls) == 2:
            print("PAUSED", rank, flush=True)
            select.select([woken], [], [], 120)
        return real_sqrt(t)

    torch.sqrt_ = sqrt_
    try:
        return real_update(cfg, params, grads, opt, inplace, **kw)
    finally:
        torch.sqrt_ = real_sqrt


optim.adamw_update = update
sys.exit(main(sys.argv[3:]))
"""


def _env(**extra):
    src = os.path.join(ROOT, "src")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1",
        **extra)


def _logged(lines):
    return {r["step"]: r for r in map(json.loads, (
        line for line in lines if line.startswith("{")))}


def _one_device(capsys, args):
    from repro_torch.launch.train import main
    assert main(args) == 0
    out = capsys.readouterr().out.splitlines()
    return out, _logged(out)


def _two_ranks(args):
    """(exit code, stdout lines) of the launcher under
    ``torch.distributed.run`` with two ranks."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    return proc.returncode, proc.stdout.splitlines() + [proc.stderr]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dirs_equal(a, b):
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """{steps: (the launcher twin's logged metrics, its checkpoints)} over
    two ranks, for 6 and 10 steps."""
    out = {}
    for steps in (6, 10):
        d = str(tmp_path_factory.mktemp(f"twin{steps}"))
        out[steps] = (W.run_launcher_twin(d, steps, TWIN),
                      os.path.join(d, "ck"))
    return out


def test_two_ranks_log_the_one_device_losses_and_checkpoint(tmp_path,
                                                            capsys, twin):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.training import init_state
    mesh_ck, one_ck = str(tmp_path / "mesh"), str(tmp_path / "one")
    rc, out = _two_ranks(BASE + ["--steps", "6", "--ckpt", mesh_ck,
                                 "--mesh", "host"])
    assert rc == 0, out
    assert "[train] mesh host: data=1,model=2, 2 ranks" in out
    mesh_log = _logged(out)
    _, one_log = _one_device(capsys, BASE + ["--steps", "6", "--ckpt", one_ck,
                                             "--mesh", "none"])
    want, twin_ck = twin[6]
    assert sorted(mesh_log) == list(range(6))
    for i in range(6):
        assert {k: mesh_log[i][k] for k in KEYS} == want[i], i
        assert mesh_log[i]["lr"] == one_log[i]["lr"], i
        for k in ("loss", "grad_norm"):
            assert abs(mesh_log[i][k] - one_log[i][k]) <= BF16_ULP * abs(
                one_log[i][k]), (i, k, mesh_log[i][k], one_log[i][k])
    assert Checkpointer(mesh_ck).all_steps() == [3, 5]
    for s in (3, 5):
        assert _dirs_equal(os.path.join(mesh_ck, f"step_{s:09d}"),
                           os.path.join(twin_ck, f"step_{s:09d}")), s
        assert sorted(os.listdir(os.path.join(mesh_ck, f"step_{s:09d}"))) \
            == sorted(os.listdir(os.path.join(one_ck, f"step_{s:09d}"))), s
    model = get_model(get_config("minicpm-2b", smoke=True))
    like = init_state(model, 0, "cpu")
    a = Checkpointer(mesh_ck).restore(5, like)
    b = Checkpointer(one_ck).restore(5, like)
    for (path, x), (_, y), (_, z) in zip(
            tree_flatten(a), tree_flatten(b),
            tree_flatten(init_state(model, 0, "cpu"))):
        assert x.shape == y.shape and x.dtype == y.dtype, path
        assert bool(torch.isfinite(x).all()), path
        gap = float((x.double() - y.double()).norm())
        moved = float((y.double() - z.double()).norm())
        assert gap <= MOVE_TOL * moved, (path, gap, moved)


def _preempted_ranks(args, pause_at, signalled):
    """(exit codes, stdout lines) of two launcher ranks started with the
    environment ``torch.distributed.run`` gives them, the ranks in
    ``signalled`` sent SIGTERM in the middle of their update at
    ``pause_at`` steps done."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", PAUSED_RANK, str(pause_at),
         ",".join(map(str, signalled)), *args],
        stdout=subprocess.PIPE, text=True, cwd=ROOT, env=_env(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
            MASTER_PORT=port)) for r in range(2)]
    lines = []
    try:
        for r in signalled:
            for line in procs[r].stdout:
                lines.append(line.rstrip("\n"))
                if lines[-1] == f"PAUSED {r}":
                    procs[r].send_signal(signal.SIGTERM)
                    break
        for p in procs:
            out, _ = p.communicate(timeout=300)
            lines += out.splitlines()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], lines


@pytest.mark.parametrize("signalled", [(0, 1), (1,)])
def test_preempted_ranks_stop_at_one_step_and_resume(tmp_path, twin,
                                                     signalled):
    from repro_torch.checkpoint import Checkpointer
    cut = str(tmp_path / "cut")
    rcs, out = _preempted_ranks(BASE + ["--ckpt", cut, "--steps", "10",
                                        "--mesh", "host"], 5, signalled)
    assert rcs == [143, 143], out
    assert "[train] SIGTERM: saved step 5, exiting" in out
    first = _logged(out)
    assert sorted(first) == list(range(6))
    assert Checkpointer(cut).all_steps() == [3, 5]
    rc, out = _two_ranks(BASE + ["--ckpt", cut, "--steps", "10",
                                 "--mesh", "host"])
    assert rc == 0, out
    assert "[train] resumed from step 5" in out
    resumed = _logged(out)
    assert sorted(resumed) == [6, 7, 8, 9]
    straight, whole = twin[10]
    for i in range(10):
        row = (first if i < 6 else resumed)[i]
        assert {k: row[k] for k in KEYS} == straight[i], i
    assert _dirs_equal(os.path.join(cut, "step_000000009"),
                       os.path.join(whole, "step_000000009"))
