"""The backward of the port's general waveguide against the JAX reference,
on the CPU: the weighted step's adjoint (its plain version against the
reference's interpreted Pallas adjoint kernel and against ``jax.grad``), the
``torch.autograd.Function`` around the step, and gradients through
``run_waveguide`` with respect to the boundary filter coefficients and the
source signal, with and without checkpointing.

Tolerances: adjoint kernels 1e-5 absolute (``tests/test_general_fast.py``);
gradients through a run 1e-3 of the largest component; checkpointed against
plain 1e-5 relative (``tests/test_gradients.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_general import (_kernel_case, _node_problem,
                                _thin_meshes, port_structure, rotated_box)
from wayverb_tpu.waveguide import run as j_run
from wayverb_tpu.waveguide import stencil_pallas as jsp
from wayverb_tpu_torch.waveguide import run as t_run
from wayverb_tpu_torch.waveguide import stencil_kernels as tsk

torch.set_num_threads(2)

KERNEL_ATOL = 1e-5
GRAD_REL = 1e-3
STEPS = 60


@pytest.fixture(scope="module")
def rotated():
    desc, _, _, js = rotated_box()
    return desc, js, port_structure(js)


@pytest.mark.parametrize("dims,against", [
    ((16, 8, 128), "pallas_interpret"), ((16, 8, 128), "jax_grad"),
    ((6, 7, 9), "jax_grad")])
def test_weighted_step_bwd_plain_matches_reference(dims, against):
    """B9's plain version against the interpreted ``_wkernel_bwd`` and
    against ``jax.grad`` of ``weighted_step_jnp``."""
    _, prev, code = _kernel_case(dims, 11)
    g = np.random.default_rng(5).normal(size=dims).astype(np.float32)
    jg, jprev, jcode = (jnp.asarray(a) for a in (g, prev, code))
    if against == "pallas_interpret":
        want = jsp._wcall(jsp._wkernel_bwd, [(jg, True), (jcode, True)],
                          True, *dims, jg.dtype)
    else:
        want = jax.grad(lambda c: jnp.sum(
            jsp.weighted_step_jnp(c, jprev, jcode) * jg))(jnp.zeros(dims))
    before = tsk.weighted_step_bwd.launches
    got = tsk.weighted_step_bwd(torch.from_numpy(g), torch.from_numpy(code))
    assert tsk.weighted_step_bwd.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)


def test_weighted_step_function_matches_jax_grad():
    """(ĝcur, ĝprev) of the Function against ``jax.grad`` of the
    reference's ``weighted_step`` (its custom VJP) at odd dims."""
    dims = (6, 7, 9)
    cur, prev, code = _kernel_case(dims, 7)
    h = np.random.default_rng(8).normal(size=dims).astype(np.float32)
    jcode, jh = jnp.asarray(code), jnp.asarray(h)
    wc, wp = jax.grad(
        lambda c, p: jnp.sum(jsp.weighted_step(c, p, jcode) * jh),
        argnums=(0, 1))(jnp.asarray(cur), jnp.asarray(prev))
    tc = torch.from_numpy(cur).requires_grad_(True)
    tp = torch.from_numpy(prev).requires_grad_(True)
    out = tsk.weighted_step(tc, tp, torch.from_numpy(code))
    assert out.grad_fn is not None and "WeightedStep" in type(
        out.grad_fn).__name__
    torch.sum(out * torch.from_numpy(h)).backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(wc), rtol=0,
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wp), rtol=0,
                               atol=KERNEL_ATOL)
    with pytest.raises(ValueError, match="out="):
        tsk.weighted_step(tc, tp, torch.from_numpy(code),
                          out=torch.empty(dims))


def test_weighted_step_gradcheck_float64():
    dims = (4, 5, 6)
    cur, prev, code = _kernel_case(dims, 9)
    tc = torch.from_numpy(cur).double().requires_grad_(True)
    tp = torch.from_numpy(prev).double().requires_grad_(True)
    tcode = torch.from_numpy(code)
    assert torch.autograd.gradcheck(
        lambda c, p: tsk.weighted_step(c, p, tcode), (tc, tp))


def _jax_grads(js, dims, jprob, checkpoint_every=0):
    source, receiver = jprob

    def loss(coef_b, coef_a, signal):
        s = dataclasses.replace(js, coef_b=coef_b, coef_a=coef_a)
        out = j_run.run_waveguide(
            s, dims, dataclasses.replace(source, signal=signal), receiver,
            STEPS, checkpoint_every=checkpoint_every)
        return jnp.sum(jnp.square(out["outputs"]))

    return jax.value_and_grad(loss, argnums=(0, 1, 2))(
        js.coef_b, js.coef_a, source.signal)


def _torch_grads(ts, dims, tprob, checkpoint_every=0, run=None):
    source, receiver = tprob
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (ts.coef_b, ts.coef_a, source.signal)]
    s = dataclasses.replace(ts, coef_b=leaves[0], coef_a=leaves[1])
    src = dataclasses.replace(source, signal=leaves[2])
    if run is None:
        out = t_run.run_waveguide(s, dims, src, receiver, STEPS,
                                  checkpoint_every=checkpoint_every)
    else:
        out = run(s, src, receiver)
    loss = torch.sum(out["outputs"] ** 2)
    loss.backward()
    return float(loss.detach()), [t.grad for t in leaves]


@pytest.fixture(scope="module")
def run_grads(rotated):
    desc, js, ts = rotated
    dims = desc.dimensions
    jprob, tprob = _node_problem(js, dims, STEPS)
    # a smooth burst instead of the impulse: every signal sample matters
    sig = np.zeros(STEPS, np.float32)
    sig[:8] = np.hanning(8)
    jprob = (dataclasses.replace(jprob[0], signal=jnp.asarray(sig)), jprob[1])
    tprob = (dataclasses.replace(tprob[0], signal=torch.from_numpy(sig)),
             tprob[1])
    return dims, tprob, _jax_grads(js, dims, jprob), \
        _torch_grads(ts, dims, tprob)


@pytest.mark.parametrize("which", ["coef_b", "coef_a", "signal"])
def test_run_waveguide_gradient_matches_jax(run_grads, which):
    """d(Σ outputs²)/d(coef_b, coef_a, signal) through ``run_waveguide`` on
    the rotated box, 60 steps, against ``jax.grad`` of the reference."""
    _, _, (jv, jg), (tv, tg) = run_grads
    k = ("coef_b", "coef_a", "signal").index(which)
    want = np.asarray(jg[k])
    assert tv == pytest.approx(float(jv), rel=1e-4)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(tg[k].numpy(), want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max())


def test_checkpointed_run_same_value_and_grad(rotated, run_grads):
    """``checkpoint_every=16`` gives the plain run's value and gradients."""
    _, _, ts = rotated
    dims, tprob, _, (v_plain, g_plain) = run_grads
    v_ck, g_ck = _torch_grads(ts, dims, tprob, checkpoint_every=16)
    np.testing.assert_allclose(v_ck, v_plain, rtol=1e-6)
    for a, b in zip(g_ck, g_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_backward_goes_through_the_adjoint(rotated, run_grads, monkeypatch):
    """The run's backward calls ``weighted_step_bwd`` once per step whose
    field carries a gradient, and nothing is counted as a launch on the
    CPU."""
    _, _, ts = rotated
    dims, tprob, _, _ = run_grads
    calls = []
    real = tsk.weighted_step_bwd

    def counting(g, code):
        calls.append(g.shape)
        return real(g, code)

    counting.launches = real.launches
    monkeypatch.setattr(tsk, "weighted_step_bwd", counting)
    _torch_grads(ts, dims, tprob)
    assert STEPS - 2 <= len(calls) <= STEPS
    assert real.launches == counting.launches


def test_regions_path_gradient_matches_jax():
    """The region path on the thin box differentiates on the CPU (plain
    autograd through the plain interior step): d/d(coef_b, coef_a, signal)
    against ``jax.grad`` of the reference's ``run_waveguide_regions``."""
    jm, tm = _thin_meshes()
    dims = jm.descriptor.dimensions
    (jsrc, jrcv), tprob = _node_problem(jm.structure, dims, STEPS)

    def loss(coef_b, coef_a, signal):
        s = dataclasses.replace(jm.structure, coef_b=coef_b, coef_a=coef_a)
        out = j_run.run_waveguide_regions(
            s, dims, dataclasses.replace(jsrc, signal=signal), jrcv, STEPS,
            tuple(jm.regions))
        return jnp.sum(jnp.square(out["outputs"]))

    jg = jax.grad(loss, argnums=(0, 1, 2))(
        jm.structure.coef_b, jm.structure.coef_a, jsrc.signal)
    _, tg = _torch_grads(
        tm.structure, dims, tprob,
        run=lambda s, src, rcv: t_run.run_waveguide_regions(
            s, dims, src, rcv, STEPS, tm.regions))
    for got, want in zip(tg, jg):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max())
