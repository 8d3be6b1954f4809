"""The training configs ``chip_smoke.py`` runs on the card: its
``lm_train_config`` keeps every published width of the arch it trains
([lmtrain]'s stablelm-1.6b, [moetrain]'s phi3.5-moe, [zootrain]'s
mamba2-1.3b and zamba2-2.7b, [tp] (g)'s deepseek-v2) and changes only the
depth and the training settings (remat, chunked attention, the loss
chunk).  The published config is the reference's.  [zootrain]'s cuts are
whole layers / groups on [lmtrain]'s recipe; [tp]'s top-1 rule keeps its
m = 2 gate and a margin of at most 2 of the 32 greedy tokens from m = 4
on."""

import dataclasses
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

SETTINGS = {"n_layers", "remat", "attn_impl", "loss_chunk"}


@pytest.mark.parametrize("arch,layers", [
    (cs.LMT_ARCH, cs.LMT_LAYERS), (cs.MOET_ARCH, cs.MOET_LAYERS),
    (cs.TP_TRAIN_ARCH, cs.TP_TRAIN_LAYERS)]
    + [(a, n) for a, n, *_ in cs.ZOOT_ARCHS]
    + [(a, n) for a, _, _, n, _ in cs.ZOOT_ARCHS])
def test_train_config_changes_only_depth_and_settings(arch, layers):
    from repro.configs import get_config as j_get_config

    published = get_config(arch)
    assert dataclasses.asdict(published) == \
        dataclasses.asdict(j_get_config(arch))
    cfg = cs.lm_train_config(arch, n_layers=layers)
    changed = {f.name for f in dataclasses.fields(published)
               if getattr(cfg, f.name) != getattr(published, f.name)}
    assert changed <= SETTINGS
    assert (cfg.n_layers, cfg.remat, cfg.attn_impl, cfg.loss_chunk) == \
        (layers, True, "chunked", cs.LMT_LOSS_CHUNK)
    assert 0 < layers <= published.n_layers


def test_moetrain_is_phi35_moe_at_its_widths():
    cfg = cs.lm_train_config(cs.MOET_ARCH, n_layers=cs.MOET_LAYERS)
    assert (cfg.name, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.n_experts, cfg.experts_per_token,
            cfg.moe_d_ff, cfg.vocab_size, cfg.dtype) == \
        ("phi3.5-moe-42b-a6.6b", 4096, 32, 8, 128, 16, 2, 6400, 32064,
         "bfloat16")
    # its fp32 pins change the dtype alone
    pin = cs.lm_train_config(cs.MOET_ARCH, n_layers=cs.MOET_LAYERS,
                             dtype="float32")
    assert dataclasses.replace(pin, dtype=cfg.dtype) == cfg


@pytest.mark.parametrize("arch,layers,S,pin_layers,why", cs.ZOOT_ARCHS)
def test_zootrain_cuts_whole_groups_on_lmtrain_recipe(arch, layers, S,
                                                      pin_layers, why):
    """Each [zootrain] arch is cut in whole layers (zamba2: whole groups,
    at least two, the pins too), within the memory rule; its tokens a
    client a step are [lmtrain]'s or, where the card's memory forced a
    cut, half of them; the run's n / c / T / rounds are [lmtrain]'s (the
    phase runs ``phase_lmtrain``, whose own constants they are)."""
    full = get_config(arch)
    assert 0 < pin_layers <= layers <= full.n_layers
    assert layers <= cs.zoot_memory_depth(arch)
    if full.family == "hybrid":
        every = full.hybrid_attn_every
        assert layers % every == 0 and pin_layers % every == 0
        assert layers // every >= 2 and pin_layers // every >= 2
    assert S in (cs.LMT_S, cs.LMT_S // 2)
    assert why and (layers < full.n_layers or S < cs.LMT_S)
    assert (cs.LMT_N, cs.LMT_C, cs.LMT_T, cs.LMT_ROUNDS) == (4, 2, 5, 2)
    assert (cs.ZOOT_PIN_N, cs.ZOOT_PIN_S) == (cs.MOET_PIN_N, cs.MOET_PIN_S)
    assert cs.ZOOT_PEAK_GB <= 60


def test_zootrain_runs_the_ssd_families():
    assert [a for a, *_ in cs.ZOOT_ARCHS] == ["mamba2-1.3b", "zamba2-2.7b"]
    assert {get_config(a).family for a, *_ in cs.ZOOT_ARCHS} == \
        {"ssm", "hybrid"}


def test_top1_rule_keeps_the_m2_gate_and_a_small_margin():
    assert cs.TP_TOP1_MIN == 0.9
    assert 0 < cs.TP_TOP1_DELTA <= 1 / 16
    # m = 2: the gate between two bf16 runs (0.9375 on an H100)
    assert not cs.top1_low(2, 0.9375)
    assert cs.top1_low(2, 0.875)
    # m = 4, four H100s over NCCL: mamba2 and zamba2 with every fp32 gate
    # held, against a one-device fp32 run
    assert not cs.top1_low(4, 0.8125, {"one_device": 0.84375,
                                       "mesh": 0.875})
    assert not cs.top1_low(4, 0.875, {"one_device": 0.875, "mesh": 0.875})
    assert not cs.top1_low(4, 0.8, {"one_device": 0.875,
                                    "mesh": 0.875 - 1 / 16})
    assert cs.top1_low(4, 0.8, {"one_device": 0.875, "mesh": 0.78125})
    with pytest.raises(ValueError):
        cs.top1_low(4, 0.8)


def test_tp_train_is_deepseek_v2_at_one_dense_and_one_moe_layer():
    cfg = cs.lm_train_config(cs.TP_TRAIN_ARCH, n_layers=cs.TP_TRAIN_LAYERS)
    assert (cfg.name, cfg.d_model, cfg.n_heads, cfg.n_experts,
            cfg.experts_per_token, cfg.moe_d_ff, cfg.kv_lora_rank,
            cfg.q_lora_rank, cfg.first_dense_layers, cfg.moe_sharding,
            cfg.dtype) == ("deepseek-v2-236b", 5120, 128, 160, 6, 1536, 512,
                           1536, 1, "tensor", "bfloat16")
    assert cfg.n_layers == cfg.first_dense_layers + 1
    assert [m for m, _ in cs.TP_TRAIN_MIXINGS] == ["einsum", "fused", "ring"]
    assert dict(cs.TP_TRAIN_MIXINGS) == {"einsum": False, "fused": False,
                                         "ring": True}
    assert "g" not in cs.TP_ZOO


def test_dryrun_combos_are_distinct_production_combos():
    from repro_torch.configs import arch_names
    from repro_torch.launch import shapes
    assert len(set(cs.DRYRUN_COMBOS)) == len(cs.DRYRUN_COMBOS)
    assert all(a in arch_names() and s in shapes.shape_names()
               for a, s in cs.DRYRUN_COMBOS)
    assert ("deepseek-v2-236b", "prefill_32k") in cs.DRYRUN_COMBOS
