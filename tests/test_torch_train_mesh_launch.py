"""The training launcher over two ranks on the CPU (gloo).

* ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train --smoke --device cpu --mesh host`` (the
  reference's 1x2 (data, model) mesh) logs the losses of ``--mesh none``
  on one device, leaves a checkpoint byte-equal to the one-device run's,
  and that checkpoint restores on one device;
* SIGTERM in the middle of step 5's in-place update, sent to both ranks
  or to rank 1 alone: every rank finishes the step, the ranks agree to
  stop, step 5 is saved (checkpoints 3 and 5) and every rank exits 143;
  resumed to 10 under ``torch.distributed.run``, the logs and the step-9
  checkpoint equal the uninterrupted one-device run's.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "minicpm-2b", "--smoke", "--batch", "2", "--seq", "16",
        "--ckpt-every", "3", "--log-every", "1", "--device", "cpu"]
KEYS = ("loss", "lr", "grad_norm")

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


def test_two_ranks_log_the_one_device_losses_and_checkpoint(tmp_path,
                                                            capsys):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import init_state
    mesh_ck, one_ck = str(tmp_path / "mesh"), str(tmp_path / "one")
    rc, out = _two_ranks(BASE + ["--steps", "6", "--ckpt", mesh_ck,
                                 "--mesh", "host"])
    assert rc == 0, out
    assert "[train] mesh host: data=1,model=2, 2 ranks" in out
    mesh_log = _logged(out)
    _, one_log = _one_device(capsys, BASE + ["--steps", "6", "--ckpt", one_ck,
                                             "--mesh", "none"])
    assert sorted(mesh_log) == list(range(6))
    for i in range(6):
        for k in KEYS:
            assert abs(mesh_log[i][k] - one_log[i][k]) <= 1e-5 * max(
                1.0, abs(one_log[i][k])), (i, k)
    assert Checkpointer(mesh_ck).all_steps() == [3, 5]
    for s in (3, 5):
        assert _dirs_equal(os.path.join(mesh_ck, f"step_{s:09d}"),
                           os.path.join(one_ck, f"step_{s:09d}")), s
    like = init_state(get_model(get_config("minicpm-2b", smoke=True)), 0,
                      "cpu")
    a = Checkpointer(mesh_ck).restore(5, like)
    b = Checkpointer(one_ck).restore(5, like)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


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
def test_preempted_ranks_stop_at_one_step_and_resume(tmp_path, capsys,
                                                     signalled):
    from repro_torch.checkpoint import Checkpointer
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
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
    _, straight = _one_device(capsys, BASE + ["--ckpt", whole, "--steps",
                                              "10", "--mesh", "none"])
    for i in range(10):
        row = (first if i < 6 else resumed)[i]
        assert {k: row[k] for k in KEYS} == {k: straight[i][k]
                                             for k in KEYS}, i
    assert _dirs_equal(os.path.join(cut, "step_000000009"),
                       os.path.join(whole, "step_000000009"))
