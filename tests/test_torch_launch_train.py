"""The port's training launcher (`launch/train.py`) on the CPU.

- Async snapshots hold their own step's state: with the checkpointer's
  writes delayed (a slow disk: `np.savez` waits `WRITE_DELAY_S`), every
  snapshot a run saves in the background equals, key for key and bit for
  bit, the snapshot of a run stopped at the same step with a blocking
  save (level 1). Before `checkpointer.to_numpy` copied CPU tensors, the
  writer saved the masters and moments of a later step, which
  `apply_updates` updates in place.
- `--production-mesh` raises the JAX package's `RuntimeError` ("need 256
  devices, have N") on a machine with fewer CUDA devices.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train

WRITE_DELAY_S = 1.0
RUN = dict(global_batch=2, seq_len=16, checkpoint_every=2, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def snapshot(path, step):
    flat, manifest = Checkpointer(str(path)).restore(step)
    assert manifest["step"] == step
    return flat


def test_async_snapshots_equal_blocking_ones(tmp_path, monkeypatch):
    cfg = reduced_config("qwen2-7b")
    blocking = {}
    for stop in (2, 4):
        launch_train.run_training(cfg, steps=stop,
                                  checkpoint_dir=str(tmp_path / f"b{stop}"),
                                  **RUN)
        blocking[stop] = snapshot(tmp_path / f"b{stop}", stop)

    savez = np.savez

    def slow_savez(*args, **kw):
        time.sleep(WRITE_DELAY_S)
        return savez(*args, **kw)

    monkeypatch.setattr(ckpt_mod.np, "savez", slow_savez)
    launch_train.run_training(cfg, steps=4,
                              checkpoint_dir=str(tmp_path / "async"), **RUN)
    for step in (2, 4):       # step 2 written in the background
        got = snapshot(tmp_path / "async", step)
        ref = blocking[step]
        assert sorted(got) == sorted(ref)
        differ = [k for k in ref if not np.array_equal(got[k], ref[k])]
        assert not differ, f"step {step}: {len(differ)} keys differ, " \
            f"e.g. {differ[:3]}"


def test_production_mesh_raises_on_fewer_devices():
    have = torch.cuda.device_count()
    if have >= 256:
        pytest.skip("this machine has the production mesh's 256 devices")
    with pytest.raises(RuntimeError, match=f"need 256 devices, have {have}"):
        launch_train.main(["--arch", "qwen2-7b", "--reduced", "--steps", "1",
                           "--production-mesh", "--device", "cpu"])
