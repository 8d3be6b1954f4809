"""The comparison that decides ``correct``, on the CPU at small shapes:
the reference against the port on one block, the control (the reference
in a lower precision in the program's place) failing it, and a whole run
with the timed path broken underneath coming out not correct.  The LM
runs in fp32 here: the CPU's bf16 products round otherwise than the
card's, so the card's limits hold its bf16 readings only."""

import time

import pytest

from chipbench import faults, harness

CNN_SMALL = {"n_clients": 8, "clusters": 2, "k_min": 2, "k_max": 3,
             "local_steps": 1, "batch": 4, "train_samples": 64,
             "test_samples": 16, "image_hw": 8, "conv1_channels": 4,
             "conv2_channels": 8, "fc1_units": 16}
LM_SMALL = {"hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 4, "intermediate_size": 128,
            "vocab_size": 256, "num_hidden_layers": 1, "seq_len": 32,
            "local_steps": 2, "loss_chunk": 16, "attn_chunk": 16,
            "torch_dtype": "float32"}
CELLS = {"cnn_paper.aggregate": CNN_SMALL, "stablelm2.fedtrain_4k": LM_SMALL}
CELL = "cnn_paper.aggregate"     # the LM's: test_chipbench_check_lm.py


def _limits(cell):
    return harness.load_json("workloads", cell)["limits"]


def _readings(cell, mode, seeds=(11,)):
    return list(harness.calibrate(harness.load_manifest(), cell,
                                  list(seeds), mode, device="cpu",
                                  sizes=CELLS[cell]))


def reference_follows_the_port(cell):
    limits = _limits(cell)
    for r in _readings(cell, "program"):
        assert r["plan_messages"] == []
        for k, limit in limits.items():
            assert r["numbers"][k] <= limit, (k, r["numbers"][k], limit)


def the_control_fails(cell):
    limits = _limits(cell)
    for r in _readings(cell, "control"):
        assert any(r["numbers"][k] > limit for k, limit in limits.items()), r


def a_broken_timed_path_is_not_correct(cell, fault):
    """The whole run past the look for a card, with the fault planted
    in the program for all of it."""
    with faults.planted(fault):
        result = harness.run_cell(
            harness.load_manifest(), cell, 23, 0.0, False,
            t_start=time.perf_counter(), device="cpu", sizes=CELLS[cell],
            traffic_changes={"rounds_per_block": 2})
    assert result["correct"] is False
    assert list(result)[-1] == "checks"


def test_reference_follows_the_port():
    reference_follows_the_port(CELL)


def test_the_control_fails():
    the_control_fails(CELL)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    a_broken_timed_path_is_not_correct(CELL, fault)
