"""The port's fused ELBO loss against the JAX package's.

Inputs come from numpy with a seed. On the CPU the port's
``fused_elbo_loss_sum`` runs its plain version; the JAX side runs the Pallas
kernel in interpret mode, as ``tests/test_pallas_elbo.py`` does. The CUDA
kernels themselves are held against the plain version on the card by
``chip_smoke.py``.

Tolerances: rel 1e-5 on the value and rtol 1e-5 / atol 1e-6 on f32
gradients, the JAX package's own for its kernel against its plain loss
(f32 sums taken in another order). bf16 gradients within one bf16 ulp: the
JAX backward rounds ``sigmoid(l) - x`` to bf16 before scaling by the
cotangent and rounds again, the port scales first and rounds once.

The forward kernel's partition of the work and its fixed-order combine
(each thread's vector steps, warp shuffles, CTA sums, then the last CTA's
order over the partials) are emulated in numpy f32 and held to the plain
version at rel 1e-6, with the same bits on a second run. So is its
cross-CTA ticket, under launches one after the other and interleaved:
two launches at a time on one workspace corrupt it, which is why the
wrapper never lets them share one. The launch counter's contract (eager
launches count at once, captured ones per replay) and the workspaces (one
per stream, and each captured graph its own) are checked against a
stand-in for the kernel library.
"""

import contextlib
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multidisttorch_tpu.ops import pallas_elbo
from multidisttorch_tpu.ops.losses import elbo_loss_sum as jax_elbo_loss_sum
from multidisttorch_tpu.ops.pallas_elbo import fused_elbo_loss_sum as jax_fused
from multidisttorch_tpu_torch.ops import elbo as port_elbo
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum
from multidisttorch_tpu_torch.ops.losses import elbo_loss_sum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(batch: int, seed: int, d: int = 784, lat: int = 20):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 2, (batch, d)).astype(np.float32),
        rng.uniform(0, 1, (batch, d)).astype(np.float32),
        rng.normal(0, 1, (batch, lat)).astype(np.float32),
        rng.normal(0, 0.5, (batch, lat)).astype(np.float32),
    )


def _torch_grads(fn, logits, x, mu, logvar, beta, scale=1.0):
    """Value and grads of ``scale * fn(...)`` w.r.t. logits, x, mu, logvar."""
    ts = [torch.tensor(a, requires_grad=True) for a in (logits, x, mu, logvar)]
    value = fn(*ts, beta) * scale
    value.backward()
    return float(value.detach()), [t.grad for t in ts]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(v.astype(np.float32)), 2.0**-126))
    return np.ldexp(np.float32(1.0), e - 8)


# The widths the port's VAEs run at: the MLP VAE's 784 pixels and 20
# latents, the conv beta-VAE's 32x32x3 and 64.
WIDTHS = [(784, 20), (3072, 64)]


@pytest.mark.parametrize("beta", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("batch", [16, 96])
@pytest.mark.parametrize("d, lat", WIDTHS)
def test_value_and_grads_match_jax(d, lat, batch, beta, monkeypatch):
    if batch == 96:
        # The JAX kernel's multi-block grid (test_pallas_elbo.py:52-80).
        monkeypatch.setattr(pallas_elbo, "_VMEM_BUDGET_BYTES", 64 * 1024 * d // 784)
    logits, x, mu, logvar = _arrays(batch, seed=batch + int(beta), d=d, lat=lat)
    j = tuple(jnp.asarray(a) for a in (logits, x, mu, logvar))
    if batch == 96:
        assert pallas_elbo._block_rows(*j) < batch

    for jax_fn, port_fn in (
        (jax_fused, fused_elbo_loss_sum),
        (jax_elbo_loss_sum, elbo_loss_sum),
    ):
        jv, jg = jax.value_and_grad(
            lambda l, xx, m, lv: jax_fn(l, xx, m, lv, beta), argnums=(0, 1, 2, 3)
        )(*j)
        tv, tg = _torch_grads(port_fn, logits, x, mu, logvar, beta)
        assert tv == pytest.approx(float(jv), rel=1e-5)
        for got, ref in zip(tg, jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_matches_plain_loss_in_port():
    logits, x, mu, logvar = _arrays(32, seed=3)
    fv, fg = _torch_grads(fused_elbo_loss_sum, logits, x, mu, logvar, 2.0)
    pv, pg = _torch_grads(elbo_loss_sum, logits, x, mu, logvar, 2.0)
    assert fv == pytest.approx(pv, rel=1e-5)
    for a, b in zip(fg, pg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d, lat", WIDTHS)
def test_bf16_activations_with_f32_targets_match_jax(d, lat):
    # The mixed case the JAX package's TPU train path feeds: bf16 logits,
    # mu and logvar, f32 x. Math is f32; cotangents come back in bf16.
    logits, x, mu, logvar = _arrays(16, seed=11, d=d, lat=lat)
    jl, jm, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (logits, mu, logvar))
    jx = jnp.asarray(x)
    scale = 1.0 / 16  # the per-sample mean's cotangent, exact in bf16
    jval, jgrads = jax.value_and_grad(
        lambda l, m, lv: jax_fused(l, jx, m, lv, 1.0) * scale, argnums=(0, 1, 2)
    )(jl, jm, jv)

    tl, tm, tv = (
        torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in (logits, mu, logvar)
    )
    value = fused_elbo_loss_sum(tl, torch.tensor(x), tm, tv, 1.0) * scale
    value.backward()
    assert value.dtype == torch.float32
    assert float(value) == pytest.approx(float(jval), rel=1e-5)
    for got, ref, primal in zip((tl.grad, tm.grad, tv.grad), jgrads, (tl, tm, tv)):
        assert got.dtype == primal.dtype == torch.bfloat16
        ref32 = np.asarray(ref, dtype=np.float32)
        diff = np.abs(got.float().numpy() - ref32)
        assert np.all(diff <= _bf16_ulp(ref32)), float(diff.max())


def test_plain_versions_are_the_kernels_function():
    # The plain forward and backward the CPU path runs, against the loss
    # they fuse: the backward is the loss's gradient scaled by g.
    logits, x, mu, logvar = _arrays(8, seed=5, d=30, lat=6)
    t = [torch.tensor(a) for a in (logits, x, mu, logvar)]
    v = port_elbo.elbo_fwd_plain(*t, 3.0)
    assert v.dtype == torch.float32 and v.dim() == 0
    assert float(v) == pytest.approx(float(elbo_loss_sum(*t, 3.0)), rel=1e-5)
    g = torch.tensor(0.25)
    _, ref = _torch_grads(elbo_loss_sum, logits, x, mu, logvar, 3.0, scale=0.25)
    got = port_elbo.elbo_bwd_plain(*t, 3.0, g)
    for a, b in zip(got, (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_x_gradient_only_when_asked():
    logits, x, mu, logvar = _arrays(4, seed=9, d=12, lat=3)
    tl = torch.tensor(logits, requires_grad=True)
    tx = torch.tensor(x)  # data: no gradient asked
    fused_elbo_loss_sum(tl, tx, torch.tensor(mu), torch.tensor(logvar)).backward()
    assert tx.grad is None and tl.grad is not None


class _FakeKernels:
    """Stands in for the kernel library: records the C entry each launch
    reaches, with its arguments, and returns ``err`` from it."""

    def __init__(self):
        self.calls, self.args, self.err = [], [], 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.err

        return entry


@contextlib.contextmanager
def _stand_in_kernels(monkeypatch):
    """The wrappers against a stand-in library on an H100-like card (132
    SMs), CPU tensors let through to the launch; yields the library and
    switches: ``capturing`` (whether a CUDA-graph capture is under way) and
    ``stream`` (the current stream's handle)."""
    lib, now = _FakeKernels(), types.SimpleNamespace(capturing=False, stream=0)
    with monkeypatch.context() as mp:
        mp.setattr(port_elbo, "_kernels", lambda: lib)
        mp.setattr(port_elbo, "_check_kernel_operands", lambda *tensors: None)
        mp.setattr(port_elbo, "_sms", lambda idx: 132)
        mp.setattr(port_elbo, "_stream", lambda dev: now.stream)
        mp.setattr(port_elbo, "_plans", {})
        mp.setattr(port_elbo, "_workspaces", {})
        mp.setattr(port_elbo, "LAUNCHES", {"elbo_fwd": 0, "elbo_bwd": 0})
        mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: now.capturing)
        yield lib, now


def test_non_cpu_tensors_launch_the_kernel_or_raise(monkeypatch):
    # A tensor that is not on the CPU never takes the plain version: on this
    # machine (no CUDA) the kernel path raises instead of falling back.
    before = dict(port_elbo.LAUNCHES)
    meta = [torch.empty(4, 8, device="meta"), torch.empty(4, 8, device="meta"),
            torch.empty(4, 2, device="meta"), torch.empty(4, 2, device="meta")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_elbo_loss_sum(*meta)
    cpu = [torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(4, 2), torch.zeros(4, 2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_elbo.elbo_fwd_cuda(*cpu, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_elbo.elbo_bwd_cuda(*cpu, 1.0, torch.tensor(1.0))
    assert port_elbo.LAUNCHES == before

    # The counter's contract: LAUNCHES counts the launches the card ran.
    ops = [torch.zeros(128, 784), torch.zeros(128, 784), torch.zeros(128, 20), torch.zeros(128, 20)]
    g = torch.tensor(1.0)
    with _stand_in_kernels(monkeypatch) as (lib, now):
        # An eager call counts at once, one per wrapper call.
        port_elbo.elbo_fwd_cuda(*ops, 1.0)
        port_elbo.elbo_bwd_cuda(*ops, 1.0, g)
        assert lib.calls == ["mdt_elbo_fwd", "mdt_elbo_bwd"]
        assert port_elbo.LAUNCHES == {"elbo_fwd": 1, "elbo_bwd": 1}
        # A call recorded into a CUDA graph counts nothing at capture; its
        # capture scope tallies it, and each replay adds the tally.
        now.capturing = True
        with port_elbo.capture_scope() as scope:
            port_elbo.elbo_fwd_cuda(*ops, 1.0)
            port_elbo.elbo_bwd_cuda(*ops, 1.0, g)
            port_elbo.elbo_bwd_cuda(*ops, 1.0, g)
        assert scope.launches == {"elbo_fwd": 1, "elbo_bwd": 2}
        assert port_elbo.LAUNCHES == {"elbo_fwd": 1, "elbo_bwd": 1}
        for _ in range(3):
            port_elbo.count_replay(scope)
        assert port_elbo.LAUNCHES == {"elbo_fwd": 4, "elbo_bwd": 7}
        # A capture outside any scope would be counted by no one and share
        # the stream's workspace: it raises, and launches nothing.
        for call in (lambda: port_elbo.elbo_fwd_cuda(*ops, 1.0),
                     lambda: port_elbo.elbo_bwd_cuda(*ops, 1.0, g)):
            with pytest.raises(RuntimeError, match="outside elbo.capture_scope"):
                call()
        assert lib.calls.count("mdt_elbo_fwd") == 2 and lib.calls.count("mdt_elbo_bwd") == 3
        assert port_elbo.LAUNCHES == {"elbo_fwd": 4, "elbo_bwd": 7}
        # A launch that fails raises and counts nothing.
        now.capturing = False
        lib.err = 700
        with pytest.raises(RuntimeError, match="elbo_fwd launch failed with CUDA error 700"):
            port_elbo.elbo_fwd_cuda(*ops, 1.0)
        with pytest.raises(RuntimeError, match="elbo_bwd launch failed with CUDA error 700"):
            port_elbo.elbo_bwd_cuda(*ops, 1.0, g)
        assert port_elbo.LAUNCHES == {"elbo_fwd": 4, "elbo_bwd": 7}


@pytest.mark.parametrize(
    "shape, fwd, bwd",
    [
        # The main path: 12,544 wide + 320 narrow vector steps.
        ((128, 784, 20), 101, 51),
        ((33, 783, 5), 26, 13),
        ((1000, 784, 20), 528, 393),
        ((8192, 784, 20), 528, 2112),
    ],
)
def test_launch_plan(shape, fwd, bwd):
    # On 132 SMs: one vector step per thread, the forward capped at four
    # CTAs per SM, the backward at 16.
    b, d, lat = shape
    assert port_elbo.fwd_grid(b * d, b * lat, 132) == fwd
    assert port_elbo.bwd_grid(b * d, b * lat, 132) == bwd


def test_the_launch_plan_reaches_the_c_entries(monkeypatch):
    ops = [torch.zeros(128, 784), torch.zeros(128, 784), torch.zeros(128, 20), torch.zeros(128, 20)]
    with _stand_in_kernels(monkeypatch) as (lib, _):
        port_elbo.elbo_fwd_cuda(*ops, 1.0)
        port_elbo.elbo_bwd_cuda(*ops, 1.0, torch.tensor(1.0))
        (ws,) = port_elbo._workspaces.values()
    fwd, bwd = lib.args
    # mdt_elbo_fwd(..., dtypes, beta, grid, ws, out, stream)
    assert fwd[7:10] == (0, 1.0, 101) and fwd[10] == ws.data_ptr() and fwd[12] == 0
    # One zero counter, then a partial per CTA of the largest grid.
    assert ws.dtype == torch.int32 and ws.numel() == 1 + 4 * 132 and not ws.any()
    # mdt_elbo_bwd(..., dlogvar, grid, stream)
    assert bwd[13:15] == (51, 0)


def test_each_captured_graph_gets_a_workspace_of_its_own(monkeypatch):
    # The forward's ticket counter is shared by every launch on a
    # workspace, so a graph never uses a stream's: each capture scope
    # makes its own, one per capture stream, zeroed when it is made (in a
    # real capture, by a fill the graph replays).
    ops = [torch.zeros(128, 784), torch.zeros(128, 784), torch.zeros(128, 20), torch.zeros(128, 20)]
    with _stand_in_kernels(monkeypatch) as (lib, now):
        port_elbo.elbo_fwd_cuda(*ops, 1.0)
        now.capturing = True
        with port_elbo.capture_scope() as first:
            port_elbo.elbo_fwd_cuda(*ops, 1.0)
            port_elbo.elbo_fwd_cuda(*ops, 1.0)
        with port_elbo.capture_scope() as second:
            port_elbo.elbo_fwd_cuda(*ops, 1.0)
            now.stream = 1
            port_elbo.elbo_fwd_cuda(*ops, 1.0)
        now.capturing = False
        port_elbo.elbo_fwd_cuda(*ops, 1.0)
        assert list(port_elbo._workspaces) == [(None, 0), (None, 1)]
        eager0, eager1 = port_elbo._workspaces.values()
    assert list(first.workspaces) == [(None, 0)] and list(second.workspaces) == [(None, 0), (None, 1)]
    workspaces = [eager0, eager1, first.workspaces[(None, 0)], *second.workspaces.values()]
    assert all(ws.numel() == 1 + 4 * 132 and not ws.any() for ws in workspaces)
    assert len({ws.data_ptr() for ws in workspaces}) == 5
    # The launches, in order: eager on stream 0; the first graph twice on
    # its workspace; the second graph on its own for streams 0 and 1; eager
    # on stream 1.
    got = [args[10] for args in lib.args]
    assert got == [eager0.data_ptr(), *[first.workspaces[(None, 0)].data_ptr()] * 2,
                   *(ws.data_ptr() for ws in second.workspaces.values()), eager1.data_ptr()]


def _ticket_combine(partials: list, order: list, workspace_of: list) -> tuple:
    """The forward's cross-CTA combine, emulated: launch i's CTA j writes
    ``partials[i][j]`` to slot j of workspace ``workspace_of[i]`` and takes
    a ticket on its counter, in ``order`` (a list of (i, j)); the CTA that
    takes ticket ``len(partials[i]) - 1`` sums its launch's slots in index
    order and sets the counter to 0. Returns each launch's sum (None if no
    CTA of it took that ticket) and each workspace's counter at the end."""
    slots = {w: np.zeros(max(map(len, partials)), np.float32) for w in workspace_of}
    counter = {w: 0 for w in workspace_of}
    out = [None] * len(partials)
    for i, j in order:
        w, grid = workspace_of[i], len(partials[i])
        slots[w][j] = partials[i][j]
        ticket, counter[w] = counter[w], counter[w] + 1
        if ticket == grid - 1:
            out[i] = _in_order(slots[w][:grid])
            counter[w] = 0
    return out, counter


def _in_order(values) -> np.float32:
    acc = np.float32(0)
    for v in values:
        acc = np.float32(acc + v)
    return acc


@pytest.mark.parametrize(
    "interleaved, workspace_of, correct",
    [(False, [0, 0, 0], True), (True, [0, 1, 2], True), (True, [0, 0, 0], False)],
    ids=["in-turn-one-workspace", "interleaved-own-workspaces", "interleaved-shared-workspace"],
)
def test_the_ticket_combine_needs_one_launch_at_a_time_per_workspace(interleaved, workspace_of, correct):
    # Three launches: 101 CTAs (the main path's grid), 26 (33x783) and 101
    # again. The CTAs of a launch take their tickets in a shuffled order. In
    # turn, or interleaved on workspaces of their own (the wrapper's rule:
    # one per stream, one per captured graph), each launch gives its exact
    # sum and leaves its counter at 0. Interleaved on one workspace, a
    # launch sums slots another is still writing, or a reset comes while
    # another launch still takes tickets (which can leave the counter off
    # for the launches after).
    rng = np.random.default_rng(17)
    partials = [rng.normal(0, 100, grid).astype(np.float32) for grid in (101, 26, 101)]
    per_launch = [[(i, int(j)) for j in rng.permutation(len(p))] for i, p in enumerate(partials)]
    if interleaved:
        rounds = itertools.zip_longest(*per_launch)
        order = [step for steps in rounds for step in steps if step is not None]
    else:
        order = [step for steps in per_launch for step in steps]
    out, counters = _ticket_combine(partials, order, workspace_of)
    exact = [o is not None and o.tobytes() == _in_order(p).tobytes() for o, p in zip(out, partials)]
    assert all(exact) == correct
    if correct:
        assert all(c == 0 for c in counters.values())
        again, _ = _ticket_combine(partials, order, workspace_of)
        assert [a.tobytes() for a in again] == [o.tobytes() for o in out]


# --- the forward's partition and combine, emulated in numpy f32 ----------

_FWD_THREADS = 128


def _block_sums(v: np.ndarray) -> np.ndarray:
    """``block_sum`` of each row of ``v`` (blocks, threads): warp shuffles
    down by 16, 8, 4, 2, 1 (lane 0 holds the warp's sum), then warp 0 the
    same over the warps' sums, zero-padded to 32 lanes."""

    def warp_tree(w):  # (..., 32) -> (...,)
        for off in (16, 8, 4, 2, 1):
            w = w[..., :off] + w[..., off : 2 * off]
        return w[..., 0]

    blocks, threads = v.shape
    warps = warp_tree(v.reshape(blocks, threads // 32, 32))
    lanes = np.zeros((blocks, 32), np.float32)
    lanes[:, : threads // 32] = warps
    return warp_tree(lanes)


def _thread_sums(terms: np.ndarray, first_step: int, n_threads: int, acc: np.ndarray) -> None:
    """Add vector steps ``first_step, first_step + 1, ...`` of 8 ``terms``
    each into ``acc``, step i to thread i % n_threads, in increasing i."""
    steps = terms.reshape(-1, 8)
    for lo in range(0, steps.shape[0], n_threads):
        rows = steps[lo : lo + n_threads]
        idx = (first_step + lo + np.arange(rows.shape[0])) % n_threads
        for k in range(8):
            acc[idx] += rows[:, k]


def _tail_sums(terms: np.ndarray, n_threads: int, acc: np.ndarray) -> None:
    """Add element j to thread j % n_threads, in increasing j."""
    for lo in range(0, terms.shape[0], n_threads):
        chunk = terms[lo : lo + n_threads]
        acc[np.arange(chunk.shape[0])] += chunk


def _emulate_fwd(logits, x, mu, logvar, beta, *, grid) -> np.float32:
    """The forward's sum on 16-byte aligned operands: each thread's share in
    its order, the CTAs' sums, then the last CTA's order over the ``grid``
    partials (strided per thread, then its block tree)."""
    f32 = np.float32
    l, xx, m, lv = (np.asarray(a, f32).reshape(-1) for a in (logits, x, mu, logvar))
    bce_terms = np.maximum(l, f32(0)) - l * xx + np.log1p(np.exp(-np.abs(l)))
    kl_terms = f32(1) + lv - m * m - np.exp(lv)
    n_threads = grid * _FWD_THREADS
    n_vw, n_vn = l.size // 8, m.size // 8
    bce, kl = np.zeros(n_threads, f32), np.zeros(n_threads, f32)
    _thread_sums(bce_terms[: 8 * n_vw], 0, n_threads, bce)
    _thread_sums(kl_terms[: 8 * n_vn], n_vw, n_threads, kl)
    _tail_sums(bce_terms[8 * n_vw :], n_threads, bce)
    _tail_sums(kl_terms[8 * n_vn :], n_threads, kl)
    partials = _block_sums((bce + f32(beta) * (f32(-0.5) * kl)).reshape(grid, _FWD_THREADS))
    last = np.zeros(_FWD_THREADS, f32)
    _tail_sums(partials, _FWD_THREADS, last)
    return _block_sums(last.reshape(1, _FWD_THREADS))[0]


@pytest.mark.parametrize(
    "shape, grid",
    [((128, 784, 20), 101), ((1000, 784, 20), 528), ((33, 783, 5), 26)],
    ids=["128", "1000", "33x783"],
)
def test_forward_partition_and_combine_match_the_plain_version(shape, grid):
    b, d, lat = shape
    logits, x, mu, logvar = _arrays(b, seed=b, d=d, lat=lat)
    assert port_elbo.fwd_grid(b * d, b * lat, 132) == grid
    v1 = _emulate_fwd(logits, x, mu, logvar, 2.0, grid=grid)
    v2 = _emulate_fwd(logits, x, mu, logvar, 2.0, grid=grid)
    assert v1.dtype == np.float32 and v1.tobytes() == v2.tobytes()
    plain = float(port_elbo.elbo_fwd_plain(*(torch.tensor(a) for a in (logits, x, mu, logvar)), 2.0))
    assert float(v1) == pytest.approx(plain, rel=1e-6)


@pytest.mark.parametrize(
    "bad, match",
    [
        ((torch.zeros(4, 8), torch.zeros(4, 7), torch.zeros(4, 2), torch.zeros(4, 2)), "shape"),
        ((torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(3, 2), torch.zeros(3, 2)), "shape"),
        ((torch.zeros(8), torch.zeros(8), torch.zeros(2), torch.zeros(2)), "2-D"),
    ],
)
def test_mis_shaped_operands_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        fused_elbo_loss_sum(*bad)


def test_the_ablation_variants_still_apply_to_the_source():
    # ops/elbo_ablation.py edits elbo.cu by substitution; each edit must
    # find its text exactly once, or the variant would time the wrong thing.
    from multidisttorch_tpu_torch.ops import _build, elbo_ablation

    src = (_build.CSRC_DIR / "elbo.cu").read_text()
    assert elbo_ablation.VARIANTS["base"] == []
    for name, subs in elbo_ablation.VARIANTS.items():
        for old, new in subs:
            assert src.count(old) == 1, (name, old)
            assert new not in src, (name, new)
