"""The port's Adam (train/kernel_adam.py) on the CPU, where ``Adam.step``
is torch's own step and ``adam_step`` runs its plain version: against
vxtpu's ``optax.adam`` (betas 0.9 / 0.999, eps 1e-8) on the parameters the
port trains, through the optimizer state's round trip, the card path's
bookkeeping against torch's step, and the refusals. The kernel itself is
held to torch's foreach step on the card (tests/test_torch_cuda.py).

Tolerances against optax: parameters within 1e-4 of one step's size (lr),
as tests/test_torch_train.py holds them (the libraries round the bias
corrections differently), plus rtol 1e-6 for the float32 rounding of the
value itself (at the camera's lr of 1e-3 one step's 1e-4 is below an ulp
of a parameter of 1); moments within rtol 1e-5 / atol 1e-6 x max|x|.
Against torch's step on the CPU: equal bit for bit (the same tensor
ops)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vxtpu_torch.train import kernel_adam, loop

STEPS = 5
# case -> (shapes of the parameters, the learning rate the fit gives them)
CASES = {"field_table": ([(8 ** 3, 4)], loop.TrainConfig.lr),
         "soft_grid": ([(8, 8, 8), (3, 8, 8, 8)], loop.TrainConfig.lr),
         "camera": ([(3,), (), (), ()], loop.TrainConfig.cam_lr)}


def _params_and_grads(shapes, seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** -k).astype(np.float32)
              for k, s in enumerate(shapes)] for _ in range(STEPS)]
    return params, grads


def _torch_params(params):
    return [torch.tensor(p).requires_grad_(True) for p in params]


@pytest.mark.parametrize("case", list(CASES))
def test_adam_matches_optax(case):
    shapes, lr = CASES[case]
    params, grads = _params_and_grads(shapes, seed=len(case))
    ps = _torch_params(params)
    opt = kernel_adam.Adam(ps, lr=lr, betas=loop.BETAS, eps=loop.ADAM_EPS)
    for g in grads:
        for p, gi in zip(ps, g):
            p.grad = torch.tensor(gi)
        opt.step()
    jopt = optax.adam(lr, b1=loop.BETAS[0], b2=loop.BETAS[1],
                      eps=loop.ADAM_EPS)

    @jax.jit
    def jstep(g, s, p):
        upd, s = jopt.update(g, s, p)
        return optax.apply_updates(p, upd), s

    jp = tuple(jnp.asarray(p) for p in params)
    js = jopt.init(jp)
    for g in grads:
        jp, js = jstep(tuple(jnp.asarray(x) for x in g), js, jp)
    adam = js[0]
    assert int(adam.count) == STEPS
    for i, p in enumerate(ps):
        st = opt.state[p]
        assert float(st["step"]) == STEPS
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]),
                                   rtol=1e-6, atol=1e-4 * lr)
        for got, want in ((st["exp_avg"], adam.mu[i]),
                          (st["exp_avg_sq"], adam.nu[i])):
            want = np.asarray(want)
            assert got.shape == p.shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("field_kernel", [True, False])
def test_opt_state_round_trip_resumes_at_the_same_count(field_kernel):
    """read_opt_state of make_optimizer's Adam after two steps, written into
    a fresh one, reads back the same; the third step of both is equal."""
    shapes = CASES["field_table" if field_kernel else "soft_grid"][0]
    params, grads = _params_and_grads(shapes, seed=3)
    cfg = loop.TrainConfig(field_kernel=field_kernel)
    ps = _torch_params(params)
    opt = loop.make_optimizer(cfg, ps)
    assert type(opt) is kernel_adam.Adam
    for g in grads[:2]:
        for p, gi in zip(ps, g):
            p.grad = torch.tensor(gi)
        opt.step()
    state = loop.read_opt_state(opt)
    qs = [p.detach().clone().requires_grad_(True) for p in ps]
    opt2 = loop.make_optimizer(cfg, qs)
    loop.write_opt_state(opt2, state)
    back = loop.read_opt_state(opt2)
    assert back[0].count == state[0].count == 2
    for a, b in zip(back[0].mu + back[0].nu, state[0].mu + state[0].nu):
        assert torch.equal(a, b)
    for o, ts in ((opt, ps), (opt2, qs)):
        for p, gi in zip(ts, grads[2]):
            p.grad = torch.tensor(gi)
        o.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
        assert float(opt2.state[q]["step"]) == 3


@pytest.mark.parametrize("resume", [False, True])
def test_card_path_bookkeeping_equals_torch_step(resume):
    """The per-parameter loop that step() runs where a parameter lies on
    CUDA (on CPU tensors adam_step runs its plain version) equals
    torch.optim.Adam's single-tensor step bit for bit: state made on the
    first step or resumed at count 7, a parameter without a gradient
    skipped, and no kernel launch on the CPU."""
    shapes = [(8 ** 3, 4), (3,), ()]
    params, grads = _params_and_grads(shapes, seed=5)
    ps, qs = _torch_params(params), _torch_params(params)
    opt = kernel_adam.Adam(ps, lr=5e-2, betas=loop.BETAS, eps=loop.ADAM_EPS)
    ref = torch.optim.Adam(qs, lr=5e-2, betas=loop.BETAS, eps=loop.ADAM_EPS,
                           foreach=False)
    if resume:
        rng = np.random.default_rng(6)
        for p, q, s in zip(ps, qs, shapes):
            st = {"step": torch.tensor(7.0),
                  "exp_avg": torch.tensor(rng.normal(size=s) * 0.1,
                                          dtype=torch.float32),
                  "exp_avg_sq": torch.tensor(rng.random(size=s) * 0.01,
                                             dtype=torch.float32)}
            opt.state[p] = {k: x.clone() for k, x in st.items()}
            ref.state[q] = st
    kernel_adam.reset_launch_counts()
    for k, g in enumerate(grads):
        for ts in (ps, qs):
            for i, (t, gi) in enumerate(zip(ts, g)):
                t.grad = None if (k == 1 and i == 2) else torch.tensor(gi)
        opt._step_each()
        ref.step()
    assert kernel_adam.LAUNCHES["adam_step_kernel"] == 0
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], ref.state[q][key])
    assert float(opt.state[ps[2]]["step"]) == (7 if resume else 0) + STEPS - 1


def _float64(t):
    kernel_adam.adam_step(*(t.double() for _ in range(4)), 1, 1e-3,
                          loop.BETAS, loop.ADAM_EPS)


def _non_contiguous(t):
    x = torch.zeros(8, 6).t()
    kernel_adam.adam_step(x, x.clone(), x.clone(), x.clone(), 1, 1e-3,
                          loop.BETAS, loop.ADAM_EPS)


REFUSED = {
    "float64": (TypeError, _float64),
    "non_contiguous": (ValueError, _non_contiguous),
    "amsgrad": (ValueError, lambda t: kernel_adam.Adam([t], amsgrad=True)),
    "weight_decay": (ValueError,
                     lambda t: kernel_adam.Adam([t], weight_decay=0.1)),
    "maximize": (ValueError, lambda t: kernel_adam.Adam([t], maximize=True)),
    "float64_parameter": (TypeError, lambda t: kernel_adam.Adam(
        [t.detach().double().requires_grad_(True)])),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refuses_what_the_kernel_does_not_implement(case):
    exc, fn = REFUSED[case]
    with pytest.raises(exc):
        fn(torch.zeros(4, 4, requires_grad=True))
