"""stablelm-2-1.6b (hf: stabilityai/stablelm-2-1_6b) trained by Algorithm 1
at its published widths: d 2,048, 32 heads of 64, d_ff 5,632 (SiLU-gated),
vocab 100,352, LayerNorm, 25% rotary, qkv biases, untied head; bf16
params, per-layer remat, query-chunked causal attention (in bf16 on the
card's flash kernels, forward and backward), the head and loss in chunks
of 1,024.  Cut to 6 of its 24 layers (``reduced``), so
that a round (about 6.5 s) fits a 45-second window about 7 times.
n = 4 clients in 2 ``k_regular`` clusters (k in [1, 2], p_fail 0), T 5
steps of one 4,096-token sequence, eta 0.05, phi_max 1.0, bound
``regular``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from chipbench import data
from chipbench.cell import FedCell, merged_sizes, round_up

SIZES = json.loads(Path(__file__).with_suffix(".json").read_text())
LANE = 128


def leaf_shapes(s: Dict) -> Dict[str, tuple]:
    """The parameter tree's leaves by path (the program's layout: layers
    stacked on a leading axis, dense kernels (in, out))."""
    d, ff, V, L = s["hidden_size"], s["intermediate_size"], \
        s["vocab_size"], s["num_hidden_layers"]
    hd = d // s["num_attention_heads"]
    q, kv = s["num_attention_heads"] * hd, s["num_key_value_heads"] * hd
    out = {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V),
           "decoder/layers/ln1": (L, d), "decoder/layers/ln2": (L, d),
           "decoder/layers/attn/q/w": (L, d, q),
           "decoder/layers/attn/k/w": (L, d, kv),
           "decoder/layers/attn/v/w": (L, d, kv),
           "decoder/layers/attn/o/w": (L, q, d),
           "decoder/layers/mlp/gate": (L, d, ff),
           "decoder/layers/mlp/up": (L, d, ff),
           "decoder/layers/mlp/down": (L, ff, d)}
    if s["use_qkv_bias"]:
        out.update({"decoder/layers/attn/q/b": (L, q),
                    "decoder/layers/attn/k/b": (L, kv),
                    "decoder/layers/attn/v/b": (L, kv)})
    return out


def param_count(s: Dict) -> int:
    return sum(math.prod(v) for v in leaf_shapes(s).values())


def matmul_params(s: Dict) -> int:
    """N of 6 N D: the parameters of every matrix product a token goes
    through (the layers' projections and MLP, and the untied head); the
    embedding is a lookup, norms and biases are not products."""
    return sum(math.prod(v) for k, v in leaf_shapes(s).items()
               if k == "lm_head" or (k.startswith("decoder") and
                                     (k.endswith("/w") or "/mlp/" in k)))


def train_flops_per_token(s: Dict) -> int:
    """6 N + 12 L d S (PaLM, arXiv:2204.02311, App. B): forward and
    backward of the matrix products, and of the attention scores and
    their weighted sum over the whole sequence; remat's recomputation is
    not counted."""
    return 6 * matmul_params(s) + 12 * s["num_hidden_layers"] * \
        s["hidden_size"] * s["seq_len"]


def tokens_per_round(s: Dict) -> int:
    return s["n_clients"] * s["local_steps"] * s["batch"] * s["seq_len"]


def train_flops_per_round(s: Dict) -> int:
    return train_flops_per_token(s) * tokens_per_round(s)


def mix_bytes_per_round(s: Dict) -> int:
    """The ideal bytes of D2D mixing and D2S aggregation: the (n, P_pad)
    bf16 deltas read once, the bf16 global params read and written
    once."""
    P = param_count(s)
    return 2 * (s["n_clients"] * round_up(P, LANE) + 2 * P)


def model_config(s: Dict):
    """The program's ``ModelConfig`` for these sizes."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name=s["name"], family="dense", n_layers=s["num_hidden_layers"],
        d_model=s["hidden_size"], n_heads=s["num_attention_heads"],
        n_kv_heads=s["num_key_value_heads"], d_ff=s["intermediate_size"],
        vocab_size=s["vocab_size"], qkv_bias=s["use_qkv_bias"],
        rope_theta=float(s["rope_theta"]),
        rope_fraction=s["partial_rotary_factor"], norm_type="layer",
        mlp_type="swiglu", norm_eps=s["layer_norm_eps"],
        dtype=s["torch_dtype"], tie_embeddings=s["tie_word_embeddings"],
        remat=s["remat"], attn_impl=s["attn_impl"],
        attn_chunk=s["attn_chunk"], loss_chunk=s["loss_chunk"])


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_params(s: Dict, seed: int, device) -> Dict:
    """The weights on ``device`` from a generator there, a call a leaf
    (the embedding N(0, 0.02), every matrix LeCun-normal over its fan-in),
    cast to the stored dtype; norms 1, biases 0."""
    dt = _DTYPES[s["torch_dtype"]]
    gen = torch.Generator(device=device).manual_seed(
        data.block_seed(seed, 0, 3))
    flat = {}
    for k, shape in leaf_shapes(s).items():
        if k in ("final_norm",) or k.endswith(("/ln1", "/ln2")):
            flat[k] = torch.ones(shape, dtype=dt, device=device)
        elif k.endswith("/b"):
            flat[k] = torch.zeros(shape, dtype=dt, device=device)
        else:
            std = 0.02 if k == "embed" else 1.0 / math.sqrt(shape[-2])
            flat[k] = torch.randn(shape, generator=gen, device=device,
                                  dtype=torch.float32).mul_(std).to(dt)
    tree: Dict = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


class Cell(FedCell):
    PRECISION = "bf16"

    def __init__(self, traffic, seed, device, sizes):
        super().__init__(traffic, seed, device, sizes)
        s = sizes
        rng = np.random.default_rng(data.block_seed(seed, 0, 4))
        tok = rng.integers(0, s["vocab_size"], size=(1, s["seq_len"] + 1),
                           dtype=np.int64).astype(np.int32)
        self.eval_tokens = tok
        self._eval = (torch.as_tensor(tok[:, :-1], device=self.device),
                      torch.as_tensor(tok[:, 1:], device=self.device))
        self.train_flops_per_round = train_flops_per_round(s)
        self.mix_bytes_per_round = mix_bytes_per_round(s)

    def make_params(self):
        return make_params(self.sizes, self.seed, self.device)

    def make_network(self):
        from repro_torch import topology
        s = self.sizes
        return topology.make_spec(
            s["topology"], n=s["n_clients"], c=s["clusters"],
            k_range=(s["k_min"], s["k_max"]), p_fail=s["p_fail"],
            self_loops=s["self_loops"]).build()

    def loss_fn(self):
        return None          # the engine trains Model(model_cfg).loss

    def execution_extras(self):
        return {"model_cfg": model_config(self.sizes)}

    def server_config(self):
        from repro_torch.core.server import ServerConfig
        s = self.sizes
        lr = s["lr"]
        return ServerConfig(T=s["local_steps"], t_max=1,
                            phi_max=s["phi_max"], bound_kind=s["bound_kind"],
                            eta=lambda t: lr)

    def draw(self, rng):
        """One round's (tokens, targets) on the host, int32 (n, T, B, S):
        each row one sequence of S + 1 token ids drawn from the seed.  On
        a mesh the rows go whole, (n, T, B, S + 1), as the mesh runtime
        takes them."""
        s = self.sizes
        tok = rng.integers(0, s["vocab_size"],
                           size=(s["n_clients"], s["local_steps"],
                                 s["batch"], s["seq_len"] + 1),
                           dtype=np.int64).astype(np.int32)
        if self.mesh is not None:
            return torch.from_numpy(tok), tok
        return (torch.from_numpy(tok[..., :-1].copy()),
                torch.from_numpy(tok[..., 1:].copy())), tok

    def eval_batch(self):
        return self._eval

    def evaluate(self, p):
        return {}            # the window's hook only synchronises

    def reference_inputs(self):
        s = self.sizes
        return {"sizes": s, "seed": self.seed,
                "make_params": lambda device: make_params(s, self.seed,
                                                          device),
                "eval_tokens": self.eval_tokens}

    def free(self):
        super().free()
        self._eval = None


def build(traffic: Dict, seed: int, device: str,
          sizes: Optional[Dict] = None) -> Cell:
    return Cell(traffic, seed, device, merged_sizes(SIZES, sizes))
