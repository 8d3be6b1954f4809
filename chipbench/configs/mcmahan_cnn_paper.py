"""The paper's Sec. 6 experiment: the McMahan et al. CNN (arXiv:1602.05629;
two 5x5 convolutions of 32 and 64 channels with 2x2 max pooling, 512
units, 10 classes: 1,663,370 params) trained by Algorithm 1 over n = 70
clients in c = 7 ``k_regular`` D2D clusters (k in [6, 9], p_fail 0.1),
T = 5 local steps of batch 32, eta_t = 0.02 * 0.1^t, phi_max 0.06, on
label-sorted synthetic 28x28x1 data.  fp32 throughout (the engine turns
TF32 off).  Nothing is cut.
"""

from __future__ import annotations

import json
import math
from functools import partial
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from chipbench import data
from chipbench.cell import FedCell, merged_sizes, round_up

SIZES = json.loads(Path(__file__).with_suffix(".json").read_text())
LANE = 128      # the packed payload's column unit (P_pad)


def leaf_shapes(s: Dict) -> Dict[str, tuple]:
    """The parameter tree's leaves by path: kernels HWIO, dense (in,
    out), the program's layout."""
    k, c0, c1, c2 = s["kernel_size"], s["channels"], s["conv1_channels"], \
        s["conv2_channels"]
    flat = (s["image_hw"] // (s["pool"] ** 2)) ** 2 * c2
    return {"conv1/w": (k, k, c0, c1), "conv1/b": (c1,),
            "conv2/w": (k, k, c1, c2), "conv2/b": (c2,),
            "fc1/w": (flat, s["fc1_units"]), "fc1/b": (s["fc1_units"],),
            "fc2/w": (s["fc1_units"], s["n_classes"]),
            "fc2/b": (s["n_classes"],)}


def param_count(s: Dict) -> int:
    return sum(math.prod(v) for v in leaf_shapes(s).values())


def forward_flops_per_sample(s: Dict) -> int:
    """2 FLOP a multiply-add: the two 'SAME' convolutions at their
    output sizes, the two dense layers (pooling, ReLU, biases and the
    softmax are not counted)."""
    hw, k, p = s["image_hw"], s["kernel_size"], s["pool"]
    c0, c1, c2 = s["channels"], s["conv1_channels"], s["conv2_channels"]
    conv1 = 2 * hw * hw * c1 * k * k * c0
    conv2 = 2 * (hw // p) ** 2 * c2 * k * k * c1
    flat = (hw // p ** 2) ** 2 * c2
    return conv1 + conv2 + 2 * flat * s["fc1_units"] + \
        2 * s["fc1_units"] * s["n_classes"]


def train_flops_per_round(s: Dict) -> int:
    """3 x the forward (forward, data gradient, weight gradient) for each
    of the n * T * batch samples a round trains on; the evaluation is not
    counted."""
    return 3 * forward_flops_per_sample(s) * s["n_clients"] * \
        s["local_steps"] * s["batch"]


def mix_bytes_per_round(s: Dict) -> int:
    """The ideal bytes of D2D mixing and D2S aggregation, whatever kernels
    do it: the (n, P_pad) fp32 deltas read once, the global params read
    and written once."""
    P = param_count(s)
    return 4 * (s["n_clients"] * round_up(P, LANE) + 2 * P)


def make_params(s: Dict, seed: int, device) -> Dict:
    """He-normal weights and zero biases on ``device`` from one draw of a
    generator there (the same numbers for the program and the
    reference)."""
    shapes = leaf_shapes(s)
    gen = torch.Generator(device=device).manual_seed(
        data.block_seed(seed, 0, 3))
    weights = [k for k in shapes if k.endswith("/w")]
    sizes = [math.prod(shapes[k]) for k in weights]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, part in zip(weights, torch.split(flat, sizes)):
        shape = shapes[k]
        fan_in = math.prod(shape[:-1])
        tree.setdefault(k.split("/")[0], {})["w"] = \
            part.reshape(shape).mul(math.sqrt(2.0 / fan_in))
    for k, shape in shapes.items():
        if k.endswith("/b"):
            tree[k.split("/")[0]]["b"] = torch.zeros(shape, device=device)
    return tree


class Cell(FedCell):
    PRECISION = "fp32"

    def __init__(self, traffic, seed, device, sizes):
        s = sizes
        self.x, self.y = data.make_classification(
            s["train_samples"], data.block_seed(seed, 0, 0),
            n_classes=s["n_classes"], image_hw=s["image_hw"],
            noise=s["noise"])
        self.x_test, self.y_test = data.make_classification(
            s["test_samples"], data.block_seed(seed, 0, 1),
            n_classes=s["n_classes"], image_hw=s["image_hw"],
            noise=s["noise"])
        self.parts = data.label_sorted_partition(
            self.y, s["n_clients"], s["shards_per_client"],
            np.random.default_rng(data.block_seed(seed, 0, 2)))
        super().__init__(traffic, seed, device, sizes)
        self.xs = torch.as_tensor(self.x_test, device=self.device)
        self.ys = torch.as_tensor(self.y_test, device=self.device).long()
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
        from repro_torch.models import cnn
        return partial(cnn.l2_regularized_loss, cnn.cnn_apply,
                       mu=self.sizes["l2_mu"])

    def server_config(self):
        from repro_torch.core.server import ServerConfig
        s = self.sizes
        lr0, decay = s["lr0"], s["lr_decay"]
        return ServerConfig(T=s["local_steps"], t_max=1,
                            phi_max=s["phi_max"], bound_kind=s["bound_kind"],
                            eta=lambda t: lr0 * (decay ** t))

    def draw(self, rng):
        """One round's (x, y) on the host, (n, T, B, ...), as
        ``launch/train.py``'s batcher hands them to the engine: each
        client's T * B samples drawn with replacement from its shards."""
        s = self.sizes
        n, T, B = s["n_clients"], s["local_steps"], s["batch"]
        idx = np.stack([rng.choice(part, size=(T, B), replace=True)
                        for part in self.parts])
        return (torch.from_numpy(self.x[idx]),
                torch.from_numpy(self.y[idx]).long()), idx

    def eval_batch(self):
        return (self.xs, self.ys)

    def evaluate(self, p):
        """``launch/train.py``'s evaluation: test accuracy and loss on the
        test set (both read back to the host)."""
        from repro_torch.models import cnn
        with torch.no_grad():
            loss = float(self.server.engine.loss_fn(p, (self.xs, self.ys)))
        if not math.isfinite(loss):
            self.failed_rounds += 1
        return {"test_acc": cnn.accuracy(cnn.cnn_apply, p, self.xs,
                                         self.ys),
                "test_loss": loss}

    def reference_inputs(self):
        s = self.sizes
        return {"sizes": s, "seed": self.seed,
                "make_params": lambda device: make_params(s, self.seed,
                                                          device),
                "x": self.x, "y": self.y, "x_test": self.x_test,
                "y_test": self.y_test}

    def free(self):
        super().free()
        self.xs = self.ys = None


def build(traffic: Dict, seed: int, device: str,
          sizes: Optional[Dict] = None) -> Cell:
    return Cell(traffic, seed, device, merged_sizes(SIZES, sizes))
