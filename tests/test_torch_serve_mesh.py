"""The port's serving CLI on a mesh (``repro_torch.launch.serve``) on gloo
ranks on the CPU, reduced configs (vocab 512, fp32).

* The mesh rule: ``serve.mesh_shape(N)`` is the shape the reference's
  ``main`` builds from N devices (its ``make_debug_mesh`` call caught).
* ``--devices 1, 2, 4, 8`` (meshes (1, 1), (1, 2), (1, 4), (2, 4)) through
  ``serve.serve_rank``, the CLI's own per-rank function, against the
  port's one-device ``Model.prefill`` / ``decode`` on the same weights
  and prompts: a dense, an MoE and an SSD arch with the batch split over
  'data', and a dense arch whose batch the data axis does not divide
  (every client serves it whole).  The greedy tokens equal, the logits
  within 2e-4.  Worlds of 2, 4 and 8 ranks are spawned once for the
  module, 2 and 4 together, then 8 (this file run as a script: ``python
  tests/test_torch_serve_mesh.py worker RANK WORLD DIR``); the world of
  one runs in this process.
* The port's world-of-one mesh steps against the reference's
  ``make_prefill_step`` / ``make_decode_step`` on its one-device mesh
  (built with Auto axes: on this jax ``make_mesh``'s Explicit axes make
  the reference's ``with_sharding_constraint`` an assert), the weights
  carried by ``models.convert``: logits within 2e-4, the tokens equal.
* The CLI end to end (``--devices 4`` spawns its own four gloo ranks;
  its printed tokens are the one-device run's) and its refusal of more
  NCCL ranks than cards.

Tolerance 2e-4 (rtol = atol): the serve helper's, fp32 sums in other
orders.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import Model

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
K, NEW, SEED = 8, 4, 0
# (arch, batch): dense, MoE and SSD with the batch split over 'data' (4),
# and one not split (3) at a data axis of 2
CASES = (("qwen2-7b", 4), ("phi3.5-moe-42b-a6.6b", 4), ("mamba2-1.3b", 4),
         ("qwen2-7b", 3))
WORLDS = (2, 4, 8)
# spawned together: at most 8 ranks beside this process at a time
GROUPS = ((2, 4), (8,))
JOIN_S = 240


def _args(arch, batch, devices):
    return serve.parse_args(["--device", "cpu", "--devices", str(devices),
                             "--arch", arch, "--batch", str(batch),
                             "--prompt-len", str(K), "--new-tokens",
                             str(NEW), "--seed", str(SEED)])


def _one_device(cfg, params, prompts, new):
    """The port's one-device greedy serve: (tokens, logits)."""
    model = Model(cfg, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(params, prompts,
                                      max_len=prompts.shape[1] + new)
        steps = [logits]
        for i in range(new - 1):
            logits, cache = model.decode(params, cache,
                                         torch.argmax(logits, -1),
                                         prompts.shape[1] + i)
            steps.append(logits)
    logits = torch.stack(steps, 1).float()
    return torch.argmax(logits, -1), logits


def _inputs(arch, batch):
    """The CLI's config, weights and prompts for ``arch`` (its seed)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), vocab_size=512)
    params = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, K)))
    return cfg, params, prompts


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, out: Path) -> None:
    torch.set_num_threads(1)
    res = {}
    for i, (arch, batch) in enumerate(CASES):
        got = serve.serve_rank(rank, _args(arch, batch, world),
                               str(out / f"store{i}"))
        res[f"{i}/tokens"] = got["tokens"].numpy()
        if rank == 0:
            res[f"{i}/logits"] = got["logits"].numpy()
            res[f"{i}/mesh"] = np.asarray(list(got["mesh"].values()))
    np.savez(out / f"rank{rank}.npz", **res)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    dirs, procs, ref, one = {}, [], {}, {}
    try:
        for k, group in enumerate(GROUPS):
            procs = []
            for world in group:
                dirs[world] = tmp_path_factory.mktemp(f"world{world}")
                procs += [subprocess.Popen(
                    [sys.executable, str(HERE), "worker", str(r), str(world),
                     str(dirs[world])], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT) for r in range(world)]
            if k == 0:
                # meanwhile: the one-device references, and the world of
                # one in this process
                for i, (arch, batch) in enumerate(CASES):
                    ref[i] = _one_device(*_inputs(arch, batch), NEW)
                    got = serve.serve_rank(0, _args(arch, batch, 1),
                                           str(dirs[WORLDS[0]] / f"solo{i}"))
                    one[i] = dict(tokens=got["tokens"].numpy(),
                                  logits=got["logits"].numpy(),
                                  mesh=np.asarray(list(got["mesh"].values())))
            for pr in procs:
                pr.wait(timeout=JOIN_S)
            logs = [pr.stdout.read().decode(errors="replace") for pr in procs]
            assert [pr.returncode for pr in procs] == [0] * len(procs), \
                "\n".join(logs)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    # runs[devices]: each rank's list of cases
    runs = {1: [[one[i] for i in range(len(CASES))]]}
    for world in WORLDS:
        ranks = [np.load(dirs[world] / f"rank{r}.npz") for r in range(world)]
        runs[world] = [[{key: z[f"{i}/{key}"] for key in
                         ("tokens", "logits", "mesh") if f"{i}/{key}" in
                         z.files} for i in range(len(CASES))] for z in ranks]
    return ref, runs


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_mesh_rule_is_the_references(n, monkeypatch):
    import jax

    from repro.launch import serve as jserve

    class Built(Exception):
        pass

    def caught(shape, axes=None):
        raise Built(tuple(shape), tuple(axes))

    monkeypatch.setattr(jax, "devices", lambda *a: [None] * n)
    monkeypatch.setattr(jserve, "make_debug_mesh", caught)
    with pytest.raises(Built) as built:
        jserve.main(["--devices", str(n)])
    assert built.value.args == (serve.mesh_shape(n), ("data", "model"))


@pytest.mark.parametrize("devices", (1,) + WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-B{b}" for a, b in CASES])
def test_mesh_serve_matches_one_device(worlds, devices, case):
    ref, runs = worlds
    want_tokens, want_logits = ref[case]
    ranks = [r[case] for r in runs[devices]]
    assert tuple(ranks[0]["mesh"]) == serve.mesh_shape(devices)
    for r in ranks:
        # every rank gathers the whole batch's tokens
        np.testing.assert_array_equal(r["tokens"], want_tokens.numpy())
    np.testing.assert_allclose(ranks[0]["logits"], want_logits.numpy(),
                               **TOL)


@pytest.mark.parametrize("arch", ["qwen2-7b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-1.3b"])
def test_world_of_one_matches_the_reference_steps(arch, tmp_path):
    import jax
    import jax.numpy as jnp
    import torch.distributed as dist
    from jax.sharding import Mesh

    from repro.configs import get_config as j_get_config
    from repro.fl import make_decode_step, make_prefill_step
    from repro.models.model import Model as JModel
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.convert import params_from_numpy

    jcfg = dataclasses.replace(j_get_config(arch, reduced=True),
                               vocab_size=512)
    cfg = dataclasses.replace(get_config(arch, reduced=True), vocab_size=512)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jp = JModel(jcfg).init(jax.random.key(SEED))
    prompts = np.random.default_rng(SEED).integers(0, 512, (2, K))
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    prefill = make_prefill_step(jcfg, jmesh, ("data",), cache_len=K + NEW)
    decode = make_decode_step(jcfg, jmesh, ("data",))
    with jax.set_mesh(jmesh):
        logits, cache = prefill(jp, jnp.asarray(prompts, jnp.int32))
        steps = [np.asarray(logits)]
        for i in range(NEW - 1):
            logits, cache = decode(jp, cache,
                                   jnp.argmax(logits, -1).astype(jnp.int32),
                                   jnp.asarray(K + i, jnp.int32))
            steps.append(np.asarray(logits))
    want = np.stack(steps, 1)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"), device="cpu")
        got = serve.serve(mesh, cfg,
                          params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu"),
                          torch.as_tensor(prompts), new_tokens=NEW)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got["tokens"].numpy(), want.argmax(-1))
    np.testing.assert_allclose(got["logits"].numpy(), want, **TOL)


def test_cli_serves_on_four_gloo_ranks():
    tokens, _ = _one_device(*_inputs("mamba2-1.3b", 4), NEW)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--devices", "4", "--arch", "mamba2-1.3b", "--batch", "4",
         "--prompt-len", str(K), "--new-tokens", str(NEW)],
        env=env, capture_output=True, text=True, timeout=JOIN_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "mesh: {'data': 1, 'model': 4}"
    assert "params on 4 cpu ranks" in lines[1]
    assert lines[2].startswith("prefill: 4x8 tokens in ")
    assert lines[3].startswith("decode:  3 steps x 4 seqs in ")
    assert lines[4:6] == [f"  seq{b}: {tokens[b].tolist()}"
                          for b in range(2)]


@pytest.mark.parametrize("devices,cards", [(2, 1), (4, 2), (8, 4), (4, 0)])
def test_cli_refuses_more_ranks_than_cards(devices, cards, monkeypatch):
    # no process group is made and no rank spawned: the count is refused
    # before anything runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit, match=rf"--devices {devices} needs "
                       rf"{devices} CUDA devices .* found {cards}"):
        serve.main(["--devices", str(devices), "--arch", "qwen2-7b"])


def test_cli_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--devices", "4", "--arch", "qwen2-7b"])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
