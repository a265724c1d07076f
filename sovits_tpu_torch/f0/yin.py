"""YIN F0 estimator (de Cheveigné & Kawahara 2002), vectorized (counterpart
of ``sovits_tpu/f0/yin.py``, a numpy copy).

Difference function computed for all frames at once via FFT autocorrelation,
cumulative-mean-normalized, absolute threshold + parabolic interpolation.
Host-side numpy, like all preprocessing in this framework.
"""

from __future__ import annotations

import numpy as np

from .base import F0Predictor


class YinF0Predictor(F0Predictor):
    name = "yin"
    threshold = 0.15

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        fs = float(self.sampling_rate)
        x = np.asarray(wav, dtype=np.float64)
        tau_max = int(fs / self.f0_min) + 1
        tau_min = max(int(fs / self.f0_max), 1)
        frame_len = 2 * tau_max
        hop = self.hop_length

        pad = frame_len
        xp = np.pad(x, (0, pad))
        starts = np.arange(p_len) * hop
        idx = starts[:, None] + np.arange(frame_len)[None, :]
        idx = np.minimum(idx, len(xp) - 1)
        frames = xp[idx]  # [p_len, frame_len]

        # difference function d(tau) = sum_{j<W} (x_j - x_{j+tau})^2
        #                            = r0_W + r_t(0) - 2 * cc(tau)
        # with cc(tau) = sum_{j<W} x_j x_{j+tau}: a cross-correlation of the
        # first W samples against the whole frame (FFT-based, all frames).
        w = tau_max
        nfft = 2 * frame_len
        f_head = np.fft.rfft(frames * (np.arange(frame_len) < w)[None, :], n=nfft, axis=1)
        f_full = np.fft.rfft(frames, n=nfft, axis=1)
        cc = np.fft.irfft(np.conj(f_head) * f_full, axis=1)[:, : tau_max + 1]
        energy = np.cumsum(frames**2, axis=1)
        e_full = np.concatenate([np.zeros((p_len, 1)), energy], axis=1)
        r0 = e_full[:, w] - e_full[:, 0]
        rt = e_full[:, w + np.arange(tau_max + 1)] - e_full[:, np.arange(tau_max + 1)]
        d = r0[:, None] + rt - 2 * cc

        # cumulative mean normalized difference
        tau = np.arange(1, tau_max + 1)
        cmndf = np.ones((p_len, tau_max + 1))
        cum = np.cumsum(d[:, 1:], axis=1)
        cmndf[:, 1:] = d[:, 1:] * tau[None, :] / (cum + 1e-12)

        f0 = np.zeros(p_len)
        for i in range(p_len):
            c = cmndf[i]
            below = np.where(c[tau_min:tau_max] < self.threshold)[0]
            if len(below):
                t0 = below[0] + tau_min
                # walk to the local minimum
                while t0 + 1 < tau_max and c[t0 + 1] < c[t0]:
                    t0 += 1
            else:
                t0 = int(np.argmin(c[tau_min:tau_max])) + tau_min
                if c[t0] > 0.7:  # clearly aperiodic
                    continue
            # parabolic interpolation
            if 1 <= t0 < tau_max:
                denom = c[t0 - 1] - 2 * c[t0] + c[t0 + 1]
                delta = 0.5 * (c[t0 - 1] - c[t0 + 1]) / (denom + 1e-12)
                delta = float(np.clip(delta, -1, 1))
            else:
                delta = 0.0
            f0[i] = fs / (t0 + delta)
        return f0
