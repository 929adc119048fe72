"""Checkpoints of the port (``tgm_tpu_torch/train/checkpoint.py``) and the
serving example that uses them.

Mirrors ``tests/test_checkpoint.py`` (round trip, a missing path raising
``CheckpointError``, manager rotation, a full TGN carry), plus: a restored
``TGNCarry`` trains on exactly as the carry that never left memory, and the
serving example (train, checkpoint, restore, serve) runs on the CPU.
"""

import numpy as np
import pytest
import torch

from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.examples.serving import tgn_scoring
from tgm_tpu_torch.exceptions import CheckpointError
from tgm_tpu_torch.train import (
    CheckpointManager,
    DeviceEdgeStream,
    TGNPipeline,
    restore_checkpoint,
    save_checkpoint,
)


def test_save_restore_roundtrip(tmp_path):
    state = {
        "params": {"w": torch.arange(6.0).reshape(2, 3)},
        "mem": torch.ones((4, 2)),
        "count": torch.tensor(7, dtype=torch.int32),
    }
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, state)
    like = {"params": {"w": torch.zeros(2, 3)}, "mem": torch.zeros(4, 2),
            "count": torch.tensor(0, dtype=torch.int32)}
    out = restore_checkpoint(p, like=like)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    assert int(out["count"]) == 7 and out["count"].dtype == torch.int32
    # Without ``like``: the plain tree.
    assert torch.equal(restore_checkpoint(p)["mem"], state["mem"])


def test_restore_missing_raises(tmp_path):
    with pytest.raises(CheckpointError):
        restore_checkpoint(str(tmp_path / "nope"))


def test_structure_mismatch_and_no_force_raise(tmp_path):
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, {"x": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="expected"):
        restore_checkpoint(p, like={"x": torch.zeros(4)})
    with pytest.raises(CheckpointError, match="keys"):
        restore_checkpoint(p, like={"y": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="force"):
        save_checkpoint(p, {"x": torch.ones(3)}, force=False)


def test_manager_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    for step in range(4):
        mgr.save(step, {"x": torch.tensor(float(step))})
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()) == ["2", "3"]
    out = mgr.restore(like={"x": torch.tensor(0.0)})
    assert float(out["x"]) == 3.0
    assert float(mgr.restore(step=2)["x"]) == 2.0
    mgr.close()
    with pytest.raises(CheckpointError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore()


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    N, E = 16, 150
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    data = DGData.from_raw(np.sort(rng.integers(0, 900, E)), np.stack([src, dst], 1),
                           rng.normal(size=(E, 4)).astype(np.float32))
    return data, DeviceEdgeStream(DGraph(data), 32, device="cpu")


def test_tgn_carry_checkpoint(tmp_path):
    """The full carry (weights, Adam, memory, recency buffers, generator)
    round-trips, and the restored one trains on exactly as the original."""
    data, stream = _stream()
    pipe = TGNPipeline(num_nodes=16, edge_dim=4, memory_dim=8, embed_dim=8, time_dim=4,
                       num_nbrs=3, lr=1e-3, neg_high=16, edge_x_full=data.edge_x, device="cpu")
    carry = pipe.init_carry(0)
    for i in range(3):
        carry, _ = pipe.train_step(carry, stream.batch_at(i))
    p = str(tmp_path / "carry")
    save_checkpoint(p, carry)
    restored = restore_checkpoint(p, like=pipe.init_carry(1))
    before = [p_.detach().clone() for p_ in restored.params.parameters()]
    for a, b in zip(before, carry.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip((*restored.mem_state, *restored.rec_state),
                    (*carry.mem_state, *carry.rec_state)):
        assert torch.equal(a, b)
    assert torch.equal(restored.rng.get_state(), carry.rng.get_state())
    assert restored.opt_state.state_dict()["state"][0]["step"] == 3
    carry, loss = pipe.train_step(carry, stream.batch_at(3))
    restored, loss_r = pipe.train_step(restored, stream.batch_at(3))
    assert torch.equal(loss, loss_r)
    for a, b in zip(restored.params.parameters(), carry.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip((*restored.mem_state, *restored.rec_state),
                    (*carry.mem_state, *carry.rec_state)):
        assert torch.equal(a, b)
    # The restored weights moved: the comparison is not of the saved ones.
    assert any(not torch.equal(a, b) for a, b in zip(before, restored.params.parameters()))


def test_serving_example_runs_on_the_cpu(tmp_path, capsys):
    out = tgn_scoring.main(["--dataset", "synthetic-120-800", "--device", "cpu",
                            "--ckpt", str(tmp_path / "ckpt")])
    printed = capsys.readouterr().out
    assert "checkpointed full carry" in printed and "events/s" in printed
    assert (tmp_path / "ckpt" / "checkpoint.pt").exists()
    probs = out["probs"]
    assert out["events"] == probs.shape[0] > 0
    assert bool(((probs > 0) & (probs < 1)).all()) and 0.0 < out["mean_p"] < 1.0
