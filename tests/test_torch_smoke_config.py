"""The training configs ``chip_smoke.py`` runs on the card: its
``lm_train_config`` keeps every published width of the arch it trains
([lmtrain]'s stablelm-1.6b, [moetrain]'s phi3.5-moe) and changes only the
depth and the training settings (remat, chunked attention, the loss
chunk).  The published config is the reference's."""

import dataclasses
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

SETTINGS = {"n_layers", "remat", "attn_impl", "loss_chunk"}


@pytest.mark.parametrize("arch,layers", [(cs.LMT_ARCH, cs.LMT_LAYERS),
                                         (cs.MOET_ARCH, cs.MOET_LAYERS)])
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
