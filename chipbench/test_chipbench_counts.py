"""The frozen counts against numbers worked by hand, and the parameter
trees the benchmark makes against the program's own layout."""

import math

import pytest
import torch

from chipbench import harness, peaks

CNN = harness.load_module("configs", "mcmahan_cnn_paper")
LM = harness.load_module("configs", "stablelm2_1_6b")


def test_cnn_flops_and_bytes():
    s = CNN.SIZES
    # conv1 28*28*32*25*1*2, conv2 14*14*64*25*32*2, fc1 3136*512*2,
    # fc2 512*10*2
    assert CNN.forward_flops_per_sample(s) == \
        1_254_400 + 20_070_400 + 3_211_264 + 10_240 == 24_546_304
    assert 3 * CNN.forward_flops_per_sample(s) == 73_638_912
    assert CNN.train_flops_per_round(s) == 73_638_912 * 70 * 5 * 32 \
        == 824_755_814_400
    assert CNN.param_count(s) == 1_663_370
    # 70 x P_pad 1,663,488 fp32 deltas + the params read and written
    assert CNN.mix_bytes_per_round(s) == 4 * (70 * 1_663_488
                                              + 2 * 1_663_370)


def test_stablelm_flops_and_bytes():
    s = LM.SIZES
    layer = 4 * 2048 * 2048 + 3 * 2048 * 5632          # 51,380,224
    assert LM.matmul_params(s) == 6 * layer + 2048 * 100_352 \
        == 513_802_240
    assert LM.train_flops_per_token(s) == 6 * 513_802_240 \
        + 12 * 6 * 2048 * 4096 == 3_686_793_216
    assert LM.tokens_per_round(s) == 81_920
    assert math.isclose(LM.train_flops_per_round(s) / 1e12, 302.0221,
                        rel_tol=1e-6)
    P = 2 * 100_352 * 2048 + 2048 + 6 * (layer + 3 * 2048 + 2 * 2048)
    assert LM.param_count(s) == P == 719_386_624
    assert LM.mix_bytes_per_round(s) == 2 * (4 * P + 2 * P)
    assert peaks.FLOPS[LM.Cell.PRECISION] == 989e12
    assert peaks.FLOPS[CNN.Cell.PRECISION] == 67e12


def _shapes(tree):
    return {k: (tuple(v.shape), v.dtype)
            for k, v in harness.leaves_by_path(tree).items()}


def test_cnn_params_match_the_programs_layout():
    from repro_torch.models import cnn
    mine = CNN.make_params(CNN.SIZES, 5, "cpu")
    assert _shapes(mine) == _shapes(cnn.init_cnn(0))


@pytest.mark.parametrize("bias", [True, False])
def test_stablelm_params_match_the_programs_layout(bias):
    from repro_torch.models.model import Model
    s = dict(LM.SIZES, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=96, vocab_size=128,
             num_hidden_layers=2, use_qkv_bias=bias)
    cfg = LM.model_config(s)
    theirs = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert _shapes(LM.make_params(s, 3, "cpu")) == _shapes(theirs)
    assert set(LM.leaf_shapes(s)) == set(harness.leaves_by_path(theirs))
