"""The training command lines on a mesh and the multi-process demo of the
PyTorch port, on gloo ranks.

- `scripts.train_vlm` run by `parallel.spawn` on one rank (a mesh of 1)
  writes a checkpoint bit-equal to the same command run alone, without a
  process group; on 4 ranks at VCP_MESH_EXPERT=2 VCP_MESH_MODEL=2 rank 0
  alone logs (a `mesh:` line, then the step lines) and saves the gathered
  parameters, whole, with every tensor the one-device checkpoint has, and
  the other ranks print nothing. `scripts.train_answer` runs the same way
  at VCP_MESH_MODEL=2 (its answer steps carry a loss_mask).
- `parallel.multihost_demo`: 2 processes started side by side, each with 2
  ranks, one group over a TCP store on localhost: every process prints the
  mesh line, equal losses at every step and MULTIHOST_OK.

The command lines run `tiny_moe`/`tiny` at 2 steps on the CPU
(VCP_DEVICE=cpu).
"""

import contextlib
import io
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import torch

from vision_compression_project_tpu_torch.parallel import spawn

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 300
VLM_ARGS = ["--preset", "tiny_moe", "--steps", "2", "--batch", "4", "--text_len", "32", "--log_every", "1"]
ANSWER_ARGS = ["--preset", "tiny", "--steps", "2", "--batch", "2", "--text_len", "64", "--log_every", "1"]
STEP_LINE = re.compile(r"^step +\d+  loss \d+\.\d{4}  pages/s \d+\.\d  \(inst \d+\.\d\)  host enqueue ms/step "
                       r"feed (\d+\.\d\d|-) forward (\d+\.\d\d|-) backward (\d+\.\d\d|-) optimizer (\d+\.\d\d|-)$")


def _rank_main(script, argv, env):
    """A command line's main(argv) on this rank with `env` set; its stdout."""
    os.environ.update(env)
    module = __import__(f"vision_compression_project_tpu_torch.scripts.{script}", fromlist=["main"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue()


def _params(ckpt: Path) -> dict:
    return torch.load(ckpt / "checkpoint.pt", map_location="cpu", weights_only=True)["params"]


def test_train_vlm_on_a_mesh_saves_the_one_device_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("VCP_DEVICE", "cpu")
    # One thread, as each spawned rank runs: the same sums in the same order.
    alone = subprocess.run(
        [sys.executable, "-m", "vision_compression_project_tpu_torch.scripts.train_vlm", *VLM_ARGS,
         "--ckpt_dir", str(tmp_path / "alone")],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=300)
    assert alone.returncode == 0, alone.stderr[-3000:]
    one = spawn(_rank_main, 1, "train_vlm", VLM_ARGS + ["--ckpt_dir", str(tmp_path / "one")], {},
                device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)[0]
    four = spawn(_rank_main, 4, "train_vlm", VLM_ARGS + ["--ckpt_dir", str(tmp_path / "four")],
                 {"VCP_MESH_EXPERT": "2", "VCP_MESH_MODEL": "2"}, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
    want = _params(tmp_path / "alone" / "step_00000002")
    got = _params(tmp_path / "one" / "step_00000002")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert one.splitlines()[0] == "device: cpu (cpu)" and one.splitlines()[1].startswith("mesh: {'data': 1")
    lines = four[0].splitlines()
    assert lines[1] == "mesh: {'data': 1, 'seq': 1, 'expert': 2, 'model': 2} devices=4"
    assert all(STEP_LINE.match(line) for line in lines[2:4])
    assert lines[-1].startswith("final checkpoint: ") and all(out == "" for out in four[1:])
    sharded = _params(tmp_path / "four" / "step_00000002")
    assert sorted(sharded) == sorted(want)
    for k in want:
        assert sharded[k].shape == want[k].shape and sharded[k].dtype == want[k].dtype, k
        assert bool(torch.isfinite(sharded[k].float()).all()), k


def test_train_answer_on_a_model_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("VCP_DEVICE", "cpu")
    outs = spawn(_rank_main, 2, "train_answer", ANSWER_ARGS + ["--ckpt_dir", str(tmp_path / "qa")],
                 {"VCP_MESH_MODEL": "2"}, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
    lines = outs[0].splitlines()
    assert lines[1] == "mesh: {'data': 1, 'seq': 1, 'expert': 1, 'model': 2} devices=2"
    assert re.match(r"^step +2  extract \d+\.\d{4}  answer \d+\.\d{4}  ex/s", lines[3])
    assert outs[1] == "" and (tmp_path / "qa" / "step_00000002" / "checkpoint.pt").exists()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_demo_two_processes_of_two_ranks():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vision_compression_project_tpu_torch.parallel.multihost_demo", "--coordinator",
         f"localhost:{port}", "--num_processes", "2", "--process_id", str(i), "--model", "2", "--local_ranks", "2",
         "--steps", "3", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    losses = []
    for i, lines in enumerate(outs):
        assert lines[0] == (f"proc {i}: mesh {{'data': 2, 'seq': 1, 'expert': 1, 'model': 2}} over 4 devices "
                            "(2 processes x 2 local)")
        steps = [line for line in lines if re.match(rf"^proc {i}: step \d loss \d+\.\d{{6}}$", line)]
        assert len(steps) == 3 and lines[-1] == f"proc {i}: MULTIHOST_OK"
        losses.append([line.split()[-1] for line in steps])
    assert losses[0] == losses[1]
