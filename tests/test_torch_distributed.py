"""The port's multi-process path (`parallel/distributed.py`) over
`torch.distributed`: the single-process gates, the global mesh's layout and
its ValueError, and a real run of two OS processes joined over a
localhost rendezvous with gloo, as tests/test_distributed.py runs the
reference's.  Each worker imports torch and the port only.  The gathered
(H, confidence, n_inliers) of the two processes equal a single-process
batch of the same global pairs and keys (split(PRNGKey(0), 4), as the
reference's distributed batch takes them), and the rolled pairs register
(min n_inliers > 20).  NCCL needs a card per process, so the path is held
on CPU processes only.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from image_stitching_tpu_torch.core import prng
from image_stitching_tpu_torch.parallel import distributed
from image_stitching_tpu_torch.parallel import make_mesh
from image_stitching_tpu_torch.parallel.batched import make_batched_register

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
HW = (96, 128)


def _global_batch():
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 255, (4,) + HW).astype(np.float32)
    return np.stack([base, np.roll(base, (7, 5), (1, 2))], axis=1)


def test_init_distributed_single_process(monkeypatch):
    """False for one process and for a bare process without MASTER_ADDR;
    CUDA devices never fall back to gloo."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert distributed.init_distributed(num_processes=1) is False
    assert distributed.init_distributed(num_processes=0,
                                        device="cpu") is False
    assert distributed.init_distributed() is False
    assert distributed.init_distributed(device="cpu") is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="without a CUDA device"):
            distributed.init_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(ValueError, match="neither"):
        distributed.init_distributed("127.0.0.1:1", 2, 0, device="tpu")


@pytest.mark.parametrize("sp", [0, 3])
def test_make_global_mesh_sp_must_divide(sp):
    with pytest.raises(ValueError, match="must divide the per-process "
                                         "device count 2"):
        distributed.make_global_mesh(("dp", "sp"), sp=sp, devices=[CPU] * 2)


def test_make_global_mesh_single_process_layout():
    mesh = distributed.make_global_mesh(("dp", "sp"), sp=2,
                                        devices=[CPU] * 4)
    assert mesh.shape == {"dp": 2, "sp": 2}
    assert mesh.local_axis_devices("dp") == [CPU, CPU]
    batch = distributed.shard_local_batch(mesh, np.zeros((3, 5)))
    assert (batch.offset, batch.global_size) == (0, 3)


_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from image_stitching_tpu_torch.core.prng import PRNGKey, split
from image_stitching_tpu_torch.parallel.distributed import (
    init_distributed, make_global_mesh, shard_local_batch,
    batched_register_distributed)

pid = int(sys.argv[1])
assert init_distributed({addr!r}, 2, pid, local_device_ids=[0, 1],
                        device="cpu")
mesh = make_global_mesh(("dp", "sp"), sp=1)
assert mesh.shape == {{"dp": 4, "sp": 1}}, mesh.shape
rng = np.random.default_rng(42)
base = rng.uniform(0, 255, (4, 96, 128)).astype(np.float32)
pairs_global = np.stack([base, np.roll(base, (7, 5), (1, 2))], axis=1)
pairs = shard_local_batch(mesh, pairs_global[2 * pid:2 * pid + 2])
keys_global = split(PRNGKey(0, "cpu"), 4)
keys = shard_local_batch(mesh, keys_global[2 * pid:2 * pid + 2])
assert (pairs.offset, pairs.global_size) == (2 * pid, 4)
fn = batched_register_distributed(mesh, (96, 128), n_features=256,
                                  n_hyp=128)
assert keys.rows.dtype == torch.int64 and keys.rows.shape == (2, 2)
h, conf, ninl = fn(pairs, keys)
assert sorted(sys.modules).count("jax") == 0
assert not any(m.startswith("image_stitching_tpu.") for m in sys.modules)
np.savez(os.path.join({out!r}, f"proc{{pid}}.npz"), h=h.numpy(),
         conf=conf.numpy(), ninl=ninl.numpy())
print(f"proc{{pid}} OK", flush=True)
"""


def test_two_process_pipeline_matches_single(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = _WORKER.format(repo=ROOT, addr=f"127.0.0.1:{port}",
                            out=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env,
                              cwd=str(tmp_path)) for pid in range(2)]
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, \
                f"proc{pid} failed:\n{out.decode(errors='replace')}"
            assert f"proc{pid} OK" in out.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    h, conf, ninl = make_batched_register(
        make_mesh((4, 1), devices=[CPU] * 4), HW, n_features=256,
        n_hyp=128)(_global_batch(), prng.split(prng.PRNGKey(0, CPU), 4))
    for pid in range(2):
        got = np.load(tmp_path / f"proc{pid}.npz")
        assert np.array_equal(got["ninl"], ninl.numpy())
        np.testing.assert_array_equal(got["h"], h.numpy())
        np.testing.assert_array_equal(got["conf"], conf.numpy())
    assert int(ninl.min()) > 20
