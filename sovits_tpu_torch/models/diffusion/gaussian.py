"""Gaussian diffusion: schedule, training loss and samplers (counterpart of
``sovits_tpu/models/diffusion/gaussian.py``; so-vits-svc
``diffusion/diffusion.py`` with the used paths of its vendored DPM-Solver
and UniPC).

The schedule is a host numpy table in float64, as in the JAX package; the
per-step solver constants are computed on the host from its float32
copies, and each sampler is a Python loop whose body is one or more
denoiser calls and a few scaled adds on the device. Where the JAX package
runs a ``lax.scan``, the port runs the same steps one after another. The
adaptive DPM-Solver++ decides each step's size from the error of the last
one, so it reads that error back to the host once a step (the JAX
package's ``lax.while_loop``).

Layouts are so-vits-svc's, channels first: x and the spectrogram [B, M, T],
the condition [B, H, T]. ``denoise_fn(x, t, cond)`` takes the step ``t`` as
a float32 [B] tensor.

All diffusion noise (the q-sample noise, a full diffusion's start, the
ancestral sampler's step noise, the training noise) is drawn by
:func:`randn`.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

logger = logging.getLogger(__name__)


# The adaptive DPM-Solver++'s constants: first step size, error tolerances,
# step-size safety factor, end tolerance and iteration bound
# (dpm_solver_pytorch.py:953, the defaults so-vits-svc runs it with).
ADAPTIVE_H_INIT = 0.05
ADAPTIVE_ATOL = 0.0078
ADAPTIVE_RTOL = 0.05
ADAPTIVE_THETA = 0.9
ADAPTIVE_T_ERR = 1e-5
ADAPTIVE_MAX_ITERS = 200


def randn(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """N(0, 1) float32 noise of ``shape`` drawn on the host from
    ``generator`` (a CPU generator, or torch's default one when None), then
    moved to ``device``: the card and the CPU draw the same numbers. For the
    card the draw lands in pinned memory and is copied without blocking, so
    a draw does not wait for the queued work."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    host = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, pin_memory=True)
    return host.to(device, non_blocking=True)


def _f32(table: np.ndarray) -> list[float]:
    """A table's float32 values as Python floats (the JAX package's tables
    are float32 on the device)."""
    return [float(v) for v in np.asarray(table, np.float32)]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    timesteps: int = 1000
    k_step: int = 1000
    max_beta: float = 0.02
    spec_min: float = -12.0
    spec_max: float = 2.0

    def __post_init__(self):
        betas = np.linspace(1e-4, self.max_beta, self.timesteps)
        alphas_cumprod = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - ac_prev) / (1.0 - alphas_cumprod)
        tables = {
            "betas": betas,
            "alphas_cumprod": alphas_cumprod,
            "posterior_variance": posterior_variance,
            "posterior_log_variance": np.log(np.maximum(posterior_variance, 1e-20)),
            "posterior_mean_coef1": betas * np.sqrt(ac_prev) / (1.0 - alphas_cumprod),
            "posterior_mean_coef2": (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - alphas_cumprod),
        }
        for name, value in tables.items():
            object.__setattr__(self, name, value)

    # -- spec normalization ------------------------------------------------
    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2.0 - 1.0

    def denorm_spec(self, x):
        return (x + 1.0) / 2.0 * (self.spec_max - self.spec_min) + self.spec_min

    # -- q / training ------------------------------------------------------
    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_start [B, ...] noised to steps ``t`` [B] (integer)."""
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        table = lambda v: torch.as_tensor(v, dtype=x_start.dtype, device=x_start.device)  # noqa: E731
        sqrt_ac = table(np.sqrt(self.alphas_cumprod))[t].reshape(shape)
        sqrt_1m = table(np.sqrt(1.0 - self.alphas_cumprod))[t].reshape(shape)
        return sqrt_ac * x_start + sqrt_1m * noise

    def p_losses(self, denoise_fn, x_start, t, cond, noise) -> torch.Tensor:
        """Noise-prediction MSE (diffusion.py:210-223)."""
        x_noisy = self.q_sample(x_start, t, noise)
        pred = denoise_fn(x_noisy, t.float(), cond)
        return torch.mean((noise.float() - pred.float()) ** 2)

    # -- continuous-time helpers (discrete NoiseScheduleVP) -----------------
    def _log_alpha(self, t_cont: np.ndarray, n: int) -> np.ndarray:
        """Interpolated log(alpha_t) over the first n betas (dpm_solver:95-131)."""
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - self.betas[:n]))
        t_array = np.linspace(0.0, 1.0, n + 1)[1:]
        return np.interp(t_cont, t_array, log_alphas)

    def solver_times(self, t: int, steps: int) -> dict[str, np.ndarray]:
        """alpha / sigma / lambda / model-input time on the uniform grid."""
        n = t
        t_cont = np.linspace(1.0, 1.0 / n, steps + 1)
        log_alpha = self._log_alpha(t_cont, n)
        alpha = np.exp(log_alpha)
        sigma = np.sqrt(1.0 - np.exp(2.0 * log_alpha))
        lam = log_alpha - np.log(sigma)
        t_input = (t_cont - 1.0 / n) * n  # model input time in [0, n-1]
        return {
            "alpha": alpha.astype(np.float32),
            "sigma": sigma.astype(np.float32),
            "lambda": lam.astype(np.float32),
            "t_input": t_input.astype(np.float32),
        }

    def _grid(self, denoise_fn, t_start: int, steps: int, cond):
        """(alpha, sigma, lambda, x0_fn) on the uniform grid of ``steps``."""
        tbl = self.solver_times(t_start, steps)
        alpha, sigma, lam, t_input = (_f32(tbl[k]) for k in ("alpha", "sigma", "lambda", "t_input"))

        def x0_fn(x, idx):
            eps = denoise_fn(x, _steps(x, t_input[idx]), cond)
            return (x - sigma[idx] * eps) / alpha[idx]

        return alpha, sigma, lam, x0_fn

    # -- samplers ------------------------------------------------------------
    def sample_ddpm(self, denoise_fn, x, t_start: int, cond, generator) -> torch.Tensor:
        """Full ancestral chain (diffusion.py:157-164), t_start steps."""
        sqrt_recip = _f32(np.sqrt(1.0 / self.alphas_cumprod))
        sqrt_recipm1 = _f32(np.sqrt(1.0 / self.alphas_cumprod - 1.0))
        coef1, coef2 = _f32(self.posterior_mean_coef1), _f32(self.posterior_mean_coef2)
        std = [math.exp(0.5 * v) for v in _f32(self.posterior_log_variance)]
        for i in range(t_start - 1, -1, -1):
            eps = denoise_fn(x, _steps(x, i), cond)
            x0 = (sqrt_recip[i] * x - sqrt_recipm1[i] * eps).clamp(-1.0, 1.0)
            mean = coef1[i] * x0 + coef2[i] * x
            x = mean + std[i] * randn(x.shape, generator, x.device) if i > 0 else mean
        return x

    def sample_ddim(self, denoise_fn, x, t_start: int, speedup: int, cond) -> torch.Tensor:
        """DDIM with stride ``speedup`` (diffusion.py:145-155)."""
        ac = _f32(self.alphas_cumprod)
        for i in reversed(range(0, t_start, speedup)):
            a_t, a_prev = ac[i], ac[max(i - speedup, 0)]
            eps = denoise_fn(x, _steps(x, i), cond)
            x = math.sqrt(a_prev) * (
                x / math.sqrt(a_t)
                + (math.sqrt((1 - a_prev) / a_prev) - math.sqrt((1 - a_t) / a_t)) * eps
            )
        return x

    def sample_plms(self, denoise_fn, x, t_start: int, speedup: int, cond) -> torch.Tensor:
        """PLMS/PNDM (diffusion.py:167-201): Adams-Bashforth on noise preds."""
        ac = _f32(self.alphas_cumprod)

        def x_pred(x, noise_t, i):
            a_t, a_prev = ac[i], ac[max(i - speedup, 0)]
            a_sq, ap_sq = math.sqrt(a_t), math.sqrt(a_prev)
            c_x = (a_prev - a_t) / (a_sq * (a_sq + ap_sq))
            c_eps = (a_prev - a_t) / (
                a_sq * (math.sqrt((1 - a_prev) * a_t) + math.sqrt((1 - a_t) * a_prev)))
            return x + (c_x * x - c_eps * noise_t)

        hist: list[torch.Tensor] = []
        for k, i in enumerate(reversed(range(0, t_start, speedup))):
            eps = denoise_fn(x, _steps(x, i), cond)
            if k == 0:
                xp = x_pred(x, eps, i)
                eps_prev = denoise_fn(xp, _steps(x, max(i - speedup, 0)), cond)
                eps_prime = (eps + eps_prev) / 2
            elif k == 1:
                eps_prime = (3 * eps - hist[-1]) / 2
            elif k == 2:
                eps_prime = (23 * eps - 16 * hist[-1] + 5 * hist[-2]) / 12
            else:
                eps_prime = (55 * eps - 59 * hist[-1] + 37 * hist[-2] - 9 * hist[-3]) / 24
            x = x_pred(x, eps_prime, i)
            hist = (hist + [eps])[-3:]
        return x

    def sample_dpmpp_2m(self, denoise_fn, x, t_start: int, steps: int, cond) -> torch.Tensor:
        """Multistep DPM-Solver++ order 2, time_uniform, solver_type=dpmsolver:
        DPM_Solver.sample(..., order=2, skip_type='time_uniform',
        method='multistep') over NoiseScheduleVP('discrete', betas[:t_start]),
        the reference's default sampler (diffusion.py:257-303). Under 10
        steps the last step drops to order 1."""
        alpha, sigma, lam, x0_fn = self._grid(denoise_fn, t_start, steps, cond)

        def first_update(x, m_prev, i):
            phi_1 = math.expm1(-(lam[i] - lam[i - 1]))
            return sigma[i] / sigma[i - 1] * x - alpha[i] * phi_1 * m_prev

        def second_update(x, m0, m1, i):
            # m0 = model at i-1 (latest), m1 = model at i-2
            h = lam[i] - lam[i - 1]
            r0 = (lam[i - 1] - lam[i - 2]) / h
            phi_1 = math.expm1(-h)
            return (sigma[i] / sigma[i - 1] * x - alpha[i] * phi_1 * m0
                    - 0.5 * alpha[i] * phi_1 * ((m0 - m1) / r0))

        m1 = x0_fn(x, 0)
        x = first_update(x, m1, 1)
        if steps < 2:
            return x
        m0 = x0_fn(x, 1)
        for step in range(2, steps + 1):
            if step == steps and steps < 10:
                x = first_update(x, m0, step)
            else:
                x = second_update(x, m0, m1, step)
            if step < steps:
                m1, m0 = m0, x0_fn(x, step)
        return x

    def sample_dpmpp_singlestep(self, denoise_fn, x, t_start: int, steps: int, cond,
                                order: int = 2) -> torch.Tensor:
        """Singlestep DPM-Solver++ (orders 1-3, time_uniform, data prediction):
        DPM_Solver.sample(..., method='singlestep', order=order,
        skip_type='time_uniform', solver_type='dpmsolver'). On the uniform
        time grid every inner point (r1 = 1/2 midpoints, r2 = 2/3 thirds)
        lands on the fine ``solver_times`` grid, so one table serves all
        blocks."""
        if order not in (1, 2, 3):
            raise ValueError(f"singlestep DPM-Solver++ order must be 1, 2 or 3, got {order}")
        alpha, sigma, lam, x0_fn = self._grid(denoise_fn, t_start, steps, cond)
        # block order plan (get_orders_and_timesteps_for_singlestep_solver)
        if order == 1:
            orders = [1] * steps
        elif order == 2:
            orders = [2] * (steps // 2) + ([1] if steps % 2 else [])
        elif steps % 3 == 0:
            orders = [3] * (steps // 3 - 1) + [2, 1]
        elif steps % 3 == 1:
            orders = [3] * (steps // 3) + [1]
        else:
            orders = [3] * (steps // 3) + [2]

        def update_1(x, s, t):
            m_s = x0_fn(x, s)
            return sigma[t] / sigma[s] * x - alpha[t] * math.expm1(-(lam[t] - lam[s])) * m_s

        def update_2(x, s, t):
            s1 = (s + t) // 2
            h = lam[t] - lam[s]
            r1 = (lam[s1] - lam[s]) / h
            m_s = x0_fn(x, s)
            x_s1 = sigma[s1] / sigma[s] * x - alpha[s1] * math.expm1(-r1 * h) * m_s
            m_s1 = x0_fn(x_s1, s1)
            phi_1 = math.expm1(-h)
            return (sigma[t] / sigma[s] * x - alpha[t] * phi_1 * m_s
                    - (0.5 / r1) * alpha[t] * phi_1 * (m_s1 - m_s))

        def update_3(x, s, t):
            s1, s2 = s + (t - s) // 3, s + 2 * (t - s) // 3
            h = lam[t] - lam[s]
            r1, r2 = (lam[s1] - lam[s]) / h, (lam[s2] - lam[s]) / h
            m_s = x0_fn(x, s)
            x_s1 = sigma[s1] / sigma[s] * x - alpha[s1] * math.expm1(-r1 * h) * m_s
            m_s1 = x0_fn(x_s1, s1)
            phi_12 = math.expm1(-r2 * h)
            phi_22 = phi_12 / (r2 * h) + 1.0
            x_s2 = (sigma[s2] / sigma[s] * x - alpha[s2] * phi_12 * m_s
                    + (r2 / r1) * alpha[s2] * phi_22 * (m_s1 - m_s))
            m_s2 = x0_fn(x_s2, s2)
            phi_1 = math.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            return (sigma[t] / sigma[s] * x - alpha[t] * phi_1 * m_s
                    + (1.0 / r2) * alpha[t] * phi_2 * (m_s2 - m_s))

        update = {1: update_1, 2: update_2, 3: update_3}
        pos = 0
        for o in orders:
            x = update[o](x, pos, pos + o)
            pos += o
        return x

    def sample_unipc_bh2(self, denoise_fn, x, t_start: int, steps: int, cond,
                         variant: str = "bh2") -> torch.Tensor:
        """Multistep UniPC (variants bh1/bh2, order 2, data prediction):
        UniPC.sample(..., order=2, skip_type='time_uniform',
        method='multistep') (diffusion/uni_pc.py:473-592): an order-2
        predictor with rho = 1/2 and a B(h) corrector; the last step drops
        to order 1 without corrector. B(h) is expm1(h) for bh2, h for bh1."""
        alpha, sigma, lam, x0_fn = self._grid(denoise_fn, t_start, steps, cond)

        def coeffs(i):
            """(h_phi_1, B_h, b1, b2) with hh = -h (predict_x0)."""
            hh = -(lam[i] - lam[i - 1])
            h_phi_1 = math.expm1(hh)
            b_h = h_phi_1 if variant == "bh2" else hh
            h_phi_k1 = h_phi_1 / hh - 1.0
            h_phi_k2 = h_phi_k1 / hh - 0.5
            return h_phi_1, b_h, h_phi_k1 / b_h, h_phi_k2 * 2.0 / b_h

        def base(x, m_prev, i, h_phi_1):
            return sigma[i] / sigma[i - 1] * x - alpha[i] * h_phi_1 * m_prev

        m0 = x0_fn(x, 0)
        h_phi_1, b_h, _, _ = coeffs(1)
        x_t_ = base(x, m0, 1, h_phi_1)
        m_t = x0_fn(x_t_, 1)
        x = x_t_ - alpha[1] * b_h * 0.5 * (m_t - m0)
        m1, m0 = m0, m_t  # m0 = latest (at grid 1), m1 = at grid 0
        for i in range(2, steps):
            rk = (lam[i - 2] - lam[i - 1]) / (lam[i] - lam[i - 1])
            d1 = (m1 - m0) / rk
            h_phi_1, b_h, b1, b2 = coeffs(i)
            x_t_ = base(x, m0, i, h_phi_1)
            m_t = x0_fn(x_t_ - alpha[i] * b_h * 0.5 * d1, i)
            # rhos_c = solve([[1, 1], [rk, 1]], [b1, b2])
            rho2 = (b2 - rk * b1) / (1.0 - rk)
            rho1 = b1 - rho2
            x = x_t_ - alpha[i] * b_h * (rho1 * d1 + rho2 * (m_t - m0))
            m1, m0 = m0, m_t
        return base(x, m0, steps, coeffs(steps)[0])

    def sample_unipc_vary(self, denoise_fn, x, t_start: int, steps: int, cond) -> torch.Tensor:
        """Multistep UniPC variant='vary_coeff' (order 2, data prediction)
        (diffusion/uni_pc.py:369-467): for order 2 the Vandermonde inverses
        collapse to A_p = [[1]] and the corrector row [1, -rk] / (1 - rk);
        the warm-up step is the K = 1 system (corrector weight phi_2), and
        the last step drops to order 1 without corrector."""
        if steps < 2:
            raise ValueError(f"unipc-vary needs steps >= 2, got {steps}")
        alpha, sigma, lam, x0_fn = self._grid(denoise_fn, t_start, steps, cond)

        def phis(i):
            """h_phi_1..3 with hh = -h (predict_x0), uni_pc.py:426-434."""
            hh = -(lam[i] - lam[i - 1])
            phi1 = math.expm1(hh)
            phi2 = phi1 / hh - 1.0
            return phi1, phi2, phi2 / hh - 0.5

        def base(x, m_prev, i, phi1):
            return sigma[i] / sigma[i - 1] * x - alpha[i] * phi1 * m_prev

        m0 = x0_fn(x, 0)
        phi1, phi2, _ = phis(1)
        x_t_ = base(x, m0, 1, phi1)
        m_t = x0_fn(x_t_, 1)  # the predictor is x_t_ (no D1s at K = 1)
        x = x_t_ - alpha[1] * phi2 * (m_t - m0)
        m1, m0 = m0, m_t
        for i in range(2, steps):
            rk = (lam[i - 2] - lam[i - 1]) / (lam[i] - lam[i - 1])
            d1 = (m1 - m0) / rk
            phi1, phi2, phi3 = phis(i)
            x_t_ = base(x, m0, i, phi1)
            m_t = x0_fn(x_t_ - alpha[i] * phi2 * d1, i)
            # corrector row A_c[0] of inv([[1, rk/2], [1, 1/2]])
            x = (x_t_ - alpha[i] * phi2 / (1.0 - rk) * d1
                 - alpha[i] * phi3 * (-rk / (1.0 - rk)) * (m_t - m0))
            m1, m0 = m0, m_t
        return base(x, m0, steps, phis(steps)[0])

    def sample_dpmpp_adaptive(self, denoise_fn, x, t_start: int, cond,
                              order: int = 2) -> torch.Tensor:
        """Adaptive step-size singlestep DPM-Solver++ (orders 2/3):
        DPM_Solver(algorithm_type='dpmsolver++').sample(..., method='adaptive',
        order=order, solver_type='dpmsolver') (dpm_solver_pytorch.py:953-1013).
        An embedded lower/higher singlestep pair, per-element tolerance
        delta = max(atol, rtol * max(|x_lo|, |x_prev|)), RMS-over-batch error
        control accepting E <= 1, and the step law
        h <- min(theta * h * E^(-1/order), lambda_0 - lambda_s). Each step
        reads E back to the host; ``ADAPTIVE_MAX_ITERS`` bounds the loop, as
        the JAX package's ``while_loop``, and a run that reaches it is logged."""
        if order not in (2, 3):
            raise ValueError(f"adaptive DPM-Solver++ order must be 2 or 3, got {order}")
        n = t_start
        b_sz = x.shape[0]
        t_grid = np.linspace(0.0, 1.0, n + 1)[1:].astype(np.float32)
        la_np = 0.5 * np.cumsum(np.log(1.0 - self.betas[:n]))
        la_grid = la_np.astype(np.float32)
        lam_grid = (la_np - 0.5 * np.log(-np.expm1(2.0 * la_np))).astype(np.float32)

        def log_alpha(t):
            return float(np.interp(t, t_grid, la_grid))

        def marginal(t):
            la = log_alpha(t)
            return math.exp(la), math.sqrt(-math.expm1(2.0 * la))

        def lam(t):
            la = log_alpha(t)
            return la - 0.5 * math.log(-math.expm1(2.0 * la))

        def inv_lambda(lmb):
            # lam_grid decreases with t: flip for np.interp
            return float(np.interp(lmb, lam_grid[::-1], t_grid[::-1]))

        def x0_fn(x, t):
            eps = denoise_fn(x, _steps(x, (t - 1.0 / n) * n), cond)
            alpha, sigma = marginal(t)
            return (x - sigma * eps) / alpha

        def update_1(x, s, t, m_s):
            a_t, sg_t = marginal(t)
            return sg_t / marginal(s)[1] * x - a_t * math.expm1(-(lam(t) - lam(s))) * m_s

        def update_2(x, s, t, m_s, r1):
            h = lam(t) - lam(s)
            s1 = inv_lambda(lam(s) + r1 * h)
            (a_s1, sg_s1), (a_t, sg_t), sg_s = marginal(s1), marginal(t), marginal(s)[1]
            x_s1 = sg_s1 / sg_s * x - a_s1 * math.expm1(-r1 * h) * m_s
            m_s1 = x0_fn(x_s1, s1)
            phi_1 = math.expm1(-h)
            x_t = (sg_t / sg_s * x - a_t * phi_1 * m_s
                   - (0.5 / r1) * a_t * phi_1 * (m_s1 - m_s))
            return x_t, m_s1

        def update_3(x, s, t, m_s, m_s1, r1, r2):
            h = lam(t) - lam(s)
            s2 = inv_lambda(lam(s) + r2 * h)
            (a_s2, sg_s2), (a_t, sg_t), sg_s = marginal(s2), marginal(t), marginal(s)[1]
            phi_12 = math.expm1(-r2 * h)
            phi_22 = phi_12 / (r2 * h) + 1.0
            x_s2 = (sg_s2 / sg_s * x - a_s2 * phi_12 * m_s
                    + (r2 / r1) * a_s2 * phi_22 * (m_s1 - m_s))
            m_s2 = x0_fn(x_s2, s2)
            phi_1 = math.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            return (sg_t / sg_s * x - a_t * phi_1 * m_s
                    + (1.0 / r2) * a_t * phi_2 * (m_s2 - m_s))

        def pair(x, s, t):
            """(x_lower, x_higher), sharing the model calls as the reference does."""
            m_s = x0_fn(x, s)
            if order == 2:
                return update_1(x, s, t, m_s), update_2(x, s, t, m_s, r1=0.5)[0]
            x_lo, m_s1 = update_2(x, s, t, m_s, r1=1.0 / 3.0)
            return x_lo, update_3(x, s, t, m_s, m_s1, r1=1.0 / 3.0, r2=2.0 / 3.0)

        t_0 = 1.0 / n
        lambda_0 = lam(t_0)
        s, h, lambda_s, it = 1.0, ADAPTIVE_H_INIT, lam(1.0), 0
        x_prev = x
        while abs(s - t_0) > ADAPTIVE_T_ERR and it < ADAPTIVE_MAX_ITERS:
            t = inv_lambda(lambda_s + h)
            x_lo, x_hi = pair(x, s, t)
            delta = torch.clamp(ADAPTIVE_RTOL * torch.maximum(x_lo.abs(), x_prev.abs()),
                                min=ADAPTIVE_ATOL)
            err = ((x_hi - x_lo) / delta).reshape(b_sz, -1)
            e = float(err.square().mean(dim=-1).sqrt().max())  # the step's host sync
            if e <= 1.0:
                x, x_prev, s, lambda_s = x_hi, x_lo, t, lam(t)
            growth = e ** (-1.0 / order) if e > 0 else math.inf
            h = min(ADAPTIVE_THETA * h * growth, lambda_0 - lambda_s)
            it += 1
        if abs(s - t_0) > ADAPTIVE_T_ERR:
            logger.warning("sample_dpmpp_adaptive: max_iters exit before t_0 (s=%s, t_0=%s): "
                           "the result is mid-trajectory", s, t_0)
        return x

    # -- top-level dispatch --------------------------------------------------
    def sample(self, denoise_fn, cond: torch.Tensor, out_dims: int,
               gt_spec: torch.Tensor | None, k_step: int, speedup: int, method: str | None,
               generator: torch.Generator | None) -> torch.Tensor:
        """Inference path of GaussianDiffusion.forward (diffusion.py:244-390):
        cond [B, H, T], gt_spec [B, M, T] (shallow diffusion from ``k_step``)
        or None (full diffusion from noise) -> mel [B, M, T]."""
        b, _, t_frames = cond.shape
        if gt_spec is None:
            t_start = self.k_step
            x = randn((b, out_dims, t_frames), generator, cond.device)
        else:
            t_start = k_step
            norm = self.norm_spec(gt_spec.float())
            noise = randn(norm.shape, generator, cond.device)
            t = torch.full((b,), t_start - 1, dtype=torch.long, device=cond.device)
            x = self.q_sample(norm, t, noise)

        steps = t_start // max(speedup, 1)
        if method is None or speedup <= 1:
            x = self.sample_ddpm(denoise_fn, x, t_start, cond, generator)
        elif method in ("dpm-solver", "dpm-solver++"):
            x = self.sample_dpmpp_2m(denoise_fn, x, t_start, steps, cond)
        elif method in ("dpm-solver++-1s", "dpm-solver++-2s", "dpm-solver++-3s"):
            x = self.sample_dpmpp_singlestep(denoise_fn, x, t_start, steps, cond,
                                             order=int(method[-2]))
        elif method in ("unipc", "unipc-bh2", "unipc-bh1"):
            x = self.sample_unipc_bh2(denoise_fn, x, t_start, steps, cond,
                                      variant="bh1" if method.endswith("bh1") else "bh2")
        elif method == "unipc-vary":
            x = self.sample_unipc_vary(denoise_fn, x, t_start, steps, cond)
        elif method in ("dpm-solver++-adaptive", "dpm-solver++-adaptive-3"):
            x = self.sample_dpmpp_adaptive(denoise_fn, x, t_start, cond,
                                           order=3 if method.endswith("-3") else 2)
        elif method == "pndm":
            x = self.sample_plms(denoise_fn, x, t_start, speedup, cond)
        elif method == "ddim":
            x = self.sample_ddim(denoise_fn, x, t_start, speedup, cond)
        else:
            raise NotImplementedError(method)
        return self.denorm_spec(x)


def _steps(x: torch.Tensor, value: float) -> torch.Tensor:
    """The denoiser's step input: ``value`` for each of x's rows, float32."""
    return torch.full((x.shape[0],), float(value), dtype=torch.float32, device=x.device)
