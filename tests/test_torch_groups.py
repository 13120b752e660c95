"""Trial groups, collectives, runtime detection and logging: the port
against the JAX package, plus real ``torch.distributed`` worlds of gloo
processes on the CPU.

Run as a script, this file is one rank of the two-process world
(``WORLD_SIZE``/``RANK``/``MASTER_*`` from the environment).
"""

import json
import logging
import os
import random
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from multidisttorch_tpu.parallel import cluster as jax_cluster
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.utils.logging import log0 as jax_log0
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.collectives import (
    group_all_gather,
    group_pmean,
    group_psum,
)
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.steps import create_train_state, make_train_step
from multidisttorch_tpu_torch.utils import logging as port_logging
from multidisttorch_tpu_torch.utils.logging import log0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n", [3, 9])
def test_setup_groups_errors_match_jax(n):
    # 3 groups over 8 ranks would orphan 2; 9 groups exceed 8 ranks.
    match = "does not divide" if n == 3 else "exceeds"
    with pytest.raises(ValueError, match=match):
        setup_groups(n, devices=CPU8)
    with pytest.raises(ValueError, match=match):
        jax_setup_groups(n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_contiguous_rank_blocks_match_jax(n):
    port = setup_groups(n, devices=CPU8)
    ref = jax_setup_groups(n)
    assert [g.global_ranks for g in port] == [g.global_ranks for g in ref]
    assert [g.group_id for g in port] == list(range(n))
    assert all(g.size == 8 // n and g.is_local_member for g in port)


def test_allow_uneven_drops_the_remainder():
    groups = setup_groups(3, devices=CPU8, allow_uneven=True)
    assert [g.global_ranks for g in groups] == [(0, 1), (2, 3), (4, 5)]


@pytest.mark.parametrize("kw, item", [({"model_parallel": 2}, "A.13"), ({"pipeline_parallel": 2}, "A.14")])
def test_unported_parallelism_raises(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        setup_groups(1, devices=["cpu", "cpu"], **kw)


def test_multi_slot_group_in_one_process_cannot_train():
    g = setup_groups(1, devices=["cpu", "cpu"])[0]
    with pytest.raises(NotImplementedError, match="one process per device"):
        create_train_state(g, VAE(hidden_dim=8, latent_dim=2), 1e-3)
    with pytest.raises(RuntimeError, match="no process group"):
        group_psum(g, torch.ones(1))


def test_one_rank_group_collectives_return_their_input():
    g = setup_groups(1, devices=["cpu"])[0]
    x = torch.arange(3.0)
    assert group_all_gather(g, x) is x and group_psum(g, x) is x and group_pmean(g, x) is x


def test_log0_prefix_matches_jax(capsys):
    assert log0("Train Epoch: 1", trial=setup_groups(2, devices=CPU8)[1])
    port_line = capsys.readouterr().out
    assert jax_log0("Train Epoch: 1", trial=jax_setup_groups(2)[1])
    assert port_line == capsys.readouterr().out == "[0:0] Train Epoch: 1\n"
    log0("hello", "world")
    assert capsys.readouterr().out == "[0:0] hello world\n"


def test_log0_level_filter():
    logger = logging.getLogger(port_logging.LOGGER_NAME)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        assert not port_logging.log0_enabled(logging.DEBUG)
        assert not log0("chatter", level=logging.DEBUG)
        assert port_logging.log0_enabled(logging.INFO)
    finally:
        logger.setLevel(old)


ENVS = [
    {},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "3"},
    {"SLURM_NPROCS": "4", "SLURM_PROCID": "1", "SLURM_NODELIST": "g[05,07-08]"},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1", "MASTER_ADDR": "h1", "MASTER_PORT": "99"},
    {"LSB_HOSTS": "batch h1 h1 h2"},
]


@pytest.mark.parametrize("env", ENVS)
def test_process_env_and_coordinator_match_jax(env):
    a, b = cluster.detect_process_env(env), jax_cluster.detect_process_env(env)
    assert (a.num_processes, a.process_id, a.source) == (b.num_processes, b.process_id, b.source)
    assert cluster.coordinator_address(env) == jax_cluster.coordinator_address(env)
    nodes = env.get("SLURM_NODELIST", "or-condo-g[05,07-08,13],or-condo-h01")
    assert cluster.parse_slurm_nodelist(nodes) == jax_cluster.parse_slurm_nodelist(nodes)


def test_torchrun_coordinates_win():
    env = {"WORLD_SIZE": "4", "RANK": "2", "SLURM_NPROCS": "1", "SLURM_PROCID": "0"}
    assert cluster.detect_process_env(env) == cluster.ProcessEnv(4, 2, "torch")
    assert cluster.local_rank({"LOCAL_RANK": "1", "RANK": "5", "WORLD_SIZE": "8"}) == 1


def test_single_process_runtime_initialises_nothing():
    assert cluster.initialize_runtime(device="cpu", environ={}) == (1, 0)
    assert cluster.process_world() == (1, 0)


def test_default_device_is_cuda_or_raises():
    assert cluster.default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert cluster.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cluster.default_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            setup_groups(1)


# --- real worlds of gloo processes --------------------------------------

HIDDEN, LATENT = 16, 4


def _ddp_inputs():
    rng = np.random.default_rng(12)
    batch = rng.uniform(0, 1, (16, 784)).astype(np.float32)
    eps = rng.normal(0, 1, (16, LATENT)).astype(np.float32)
    return torch.tensor(batch), torch.tensor(eps)


def _gloo_rank(out_path: str) -> None:
    """One rank of the two-process world: two one-rank groups gather, then
    one two-rank group takes a DDP train step on its half of 16 rows."""
    world, rank = cluster.initialize_runtime(device="cpu")
    got = {"world": world}
    for g in setup_groups(2, device="cpu"):
        if g.is_local_member:
            got["single"] = [g.group_id, group_all_gather(g, torch.tensor([10 + rank])).tolist()]
    pair = setup_groups(1, device="cpu")[0]
    got["pair_gather"] = group_all_gather(pair, torch.tensor([rank, 10 * rank])).tolist()
    got["psum"] = float(group_psum(pair, torch.tensor(rank + 1.0)))
    got["pmean"] = float(group_pmean(pair, torch.tensor(rank + 1.0)))
    batch, eps = _ddp_inputs()
    state = create_train_state(pair, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0), 1e-3)
    rows = slice(8 * pair.local_rank, 8 * pair.local_rank + 8)
    state, metrics = make_train_step(pair)(state, batch[rows], eps=eps[rows])
    got["loss_sum"] = float(metrics["loss_sum"])
    np.savez(out_path, **{k: v.detach().numpy() for k, v in state.model.state_dict().items()})
    with open(out_path + ".json", "w") as f:
        json.dump(got, f)
    cluster.shutdown_runtime()
    assert cluster.process_world() == (1, 0)


def _free_port() -> int:
    """A free port for a world's store, picked below the kernel's ephemeral
    range: a port from inside it can be taken, between this probe and rank
    0's bind, as the local end of another concurrent world's connection,
    and rank 1 then waits for a store that never starts."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            ephemeral_lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        ephemeral_lo = 32768
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(max(1024, ephemeral_lo - 12000), ephemeral_lo)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def _launch(argv_for_rank, n: int, timeout: float) -> list[str]:
    """Run an ``n``-process world, each rank given ``timeout`` seconds in
    turn; every rank's output is kept in a file, so a rank that hangs is
    reported with what every rank printed."""
    port = _free_port()
    procs, logs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(n):
            env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO)
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(argv_for_rank(r), env=env, cwd=REPO, text=True,
                                          stdout=logs[-1], stderr=subprocess.STDOUT))
        hung = None
        try:
            for r, p in enumerate(procs):
                try:
                    p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    hung = r
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    said = "".join(f"\n--- rank {r} (exit {p.returncode}):\n{out}" for r, (p, out) in enumerate(zip(procs, outs)))
    assert hung is None, f"rank {hung} did not end within {timeout} s (port {port}){said}"
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}{said}"
    return outs


def test_two_process_gloo_groups_and_ddp_step(tmp_path):
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    _launch(lambda r: [sys.executable, __file__, outs[r]], 2, timeout=90)
    got = []
    for out in outs:
        with open(out + ".json") as f:
            got.append(json.load(f))
    assert [g["single"] for g in got] == [[0, [10]], [1, [11]]]
    assert all(g["pair_gather"] == [0, 0, 1, 10] for g in got)
    assert all(g["psum"] == 3.0 and g["pmean"] == 1.5 for g in got)

    # The same 16 rows in one process: DDP's average of the two ranks'
    # per-sample-mean gradients is the gradient of the 16-row mean
    # (rtol 1e-5: f32 sums in another order).
    one = setup_groups(1, devices=["cpu"])[0]
    batch, eps = _ddp_inputs()
    state = create_train_state(one, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0), 1e-3)
    state, metrics = make_train_step(one)(state, batch, eps=eps)
    for g in got:
        assert g["loss_sum"] == pytest.approx(float(metrics["loss_sum"]), rel=1e-5)
    ref = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    for out in outs:
        params = np.load(out + ".npz")
        for k, v in ref.items():
            np.testing.assert_allclose(params[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.multihost
def test_example_subgroup_four_processes():
    # The reference's eyeball check: four gloo processes, two per group,
    # two ids per rank.
    outs = _launch(
        lambda r: [sys.executable, "-m", "multidisttorch_tpu_torch.examples.example_subgroup",
                   "--device", "cpu", "--per-rank", "2"],
        4, timeout=240,
    )
    text = "".join(outs)
    assert "[0:0] subgroup 0 gathered: [0, 1, 2, 3]" in text
    assert "[2:0] subgroup 1 gathered: [4, 5, 6, 7]" in text
    assert text.count("gathered") == 2


if __name__ == "__main__":
    _gloo_rank(sys.argv[1])
