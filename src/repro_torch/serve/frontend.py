"""Planned audio frontend: FIR filter bank -> fused fft2d chain -> conv2d
(the port of ``repro.serve.frontend``).

Raw audio samples become encoder frame embeddings through three planned
stages, each resolved through ``autotune.resolve`` like the model GEMMs
(per-site rows in ``planned_report()`` under ``frontend.*``):

  1. **FIR filter bank** (``planned_fir``, the hand-written FIR kernel on
     the card): a ``taps``-point filter over the chunk's samples, with the
     previous chunk's ``taps - 1`` trailing samples carried as history, so
     chunked filtering equals filtering the whole utterance.
  2. **fft2d stage chain** (``planned_fft2d``, stamped ``xla``:
     ``torch.fft.fft2``): the filtered chunk as one [rows, cols] tile; the
     real output plane is the chunk's spectrogram proxy.
  3. **conv2d feature extractor** (``planned_conv2d``, the hand-written
     conv2d kernel on the card): a VALID [kp, kq] cross-correlation
     reduces the tile to the chunk's [frames_per_chunk, d_model] frames.

One chunk of ``chunk_samples`` samples makes exactly ``frames_per_chunk``
encoder frames (rows = frames_per_chunk + kp - 1, cols = d_model + kq - 1,
chunk_samples = rows * cols).  Offline and streaming paths run the same
per-chunk function, so chunked and offline features are bitwise equal.
In int16 the FIR accumulates exactly in int32 and the FFT plane is
re-quantized to int16 before the conv stage (round half to even, as
``jnp.round``), so the conv runs the int16 kernel contract.

Filter parameters and synthesized audio are drawn with numpy exactly as
the reference draws them, so both packages hold the same taps, filter
and samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.planned import (planned_conv2d, planned_fft2d,
                                         planned_fir)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Geometry + dtype of the planned audio frontend.

    ``dtype`` selects the operand dtype of the FIR and conv2d stages
    (``"int16"`` — exact integer arithmetic around the fp32 FFT — or
    ``"float32"``).  ``feature_scale`` maps the conv accumulator onto
    model-embedding magnitudes."""

    d_model: int
    frames_per_chunk: int = 8
    taps: int = 15
    kernel: tuple[int, int] = (5, 4)
    dtype: str = "int16"
    feature_scale: float = 2.0 ** -12
    seed: int = 0

    def __post_init__(self):
        if self.dtype not in ("int16", "float32"):
            raise ValueError(
                f"frontend dtype must be 'int16' or 'float32', "
                f"got {self.dtype!r}")

    @property
    def rows(self) -> int:
        return self.frames_per_chunk + self.kernel[0] - 1

    @property
    def cols(self) -> int:
        return self.d_model + self.kernel[1] - 1

    @property
    def chunk_samples(self) -> int:
        """Audio samples per chunk (= one FFT tile)."""
        return self.rows * self.cols

    def plan_keys(self) -> tuple[tuple, ...]:
        """The (kind, shape, dtype) plan requests this frontend emits."""
        kp, kq = self.kernel
        return (
            ("fir", (self.chunk_samples, self.taps), self.dtype),
            ("fft2d_stage+fft2d_stage",
             ((self.rows, self.cols), (self.rows, self.cols)), "float32"),
            ("conv2d", (self.frames_per_chunk, self.d_model, kp, kq),
             self.dtype),
        )


def _bank(fc: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic filter parameters (taps, conv kernel) from the config
    seed — small integers for int16, small normals for fp32."""
    rng = np.random.default_rng(fc.seed)
    kp, kq = fc.kernel
    if fc.dtype == "int16":
        taps = rng.integers(-3, 4, fc.taps).astype(np.int16)
        filt = rng.integers(-2, 3, (kp, kq)).astype(np.int16)
    else:
        taps = (rng.standard_normal(fc.taps) * 0.25).astype(np.float32)
        filt = (rng.standard_normal((kp, kq)) * 0.25).astype(np.float32)
    return taps, filt


class AudioFrontend:
    """Stateless-per-chunk feature extractor with an explicit FIR carry.

    ``chunk_features(carry, samples)`` consumes exactly
    ``cfg.chunk_samples`` samples and returns ``(new_carry, features
    [frames_per_chunk, d_model] float32)`` on ``device``.  The carry is
    the previous chunk's trailing ``taps - 1`` raw samples (zeros before
    the first chunk).  ``offline_features(samples)`` runs the same
    per-chunk function over every chunk of a whole utterance.
    """

    def __init__(self, cfg: FrontendConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        taps, filt = _bank(cfg)
        self.taps = torch.from_numpy(taps).to(self.device)
        self.filt = torch.from_numpy(filt).to(self.device)

    @property
    def np_dtype(self):
        return np.int16 if self.cfg.dtype == "int16" else np.float32

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.int16 if self.cfg.dtype == "int16" else torch.float32

    def init_state(self) -> torch.Tensor:
        """Zero FIR history — the carry before the first chunk."""
        return torch.zeros(self.cfg.taps - 1, dtype=self.torch_dtype,
                           device=self.device)

    def _chunk_fn(self, carry, samples):
        fc = self.cfg
        x = torch.cat([carry, samples])
        y = planned_fir(x, self.taps)                 # [chunk_samples]
        tile = y.reshape(fc.rows, fc.cols).to(torch.float32)
        re, _ = planned_fft2d(tile, torch.zeros_like(tile))
        if fc.dtype == "int16":
            # deterministic re-quantization keeps the conv stage on the
            # int16 kernel contract; torch.round is half-to-even, as
            # jnp.round
            plane = torch.round(re).clamp(-32768, 32767).to(torch.int16)
        else:
            plane = re
        feats = planned_conv2d(plane, self.filt)      # [F_c, d_model]
        feats = feats.to(torch.float32) * fc.feature_scale
        new_carry = samples[-(fc.taps - 1):]
        return new_carry, feats

    def chunk_features(self, carry, samples):
        samples = torch.as_tensor(samples, device=self.device)
        if tuple(samples.shape) != (self.cfg.chunk_samples,):
            raise ValueError(
                f"chunk must be exactly {self.cfg.chunk_samples} samples "
                f"({self.cfg.rows}x{self.cfg.cols} FFT tile), got "
                f"{tuple(samples.shape)}")
        if samples.dtype != self.torch_dtype:
            raise TypeError(
                f"chunk dtype {samples.dtype} != frontend dtype "
                f"{self.cfg.dtype}")
        return self._chunk_fn(carry, samples)

    def split(self, samples) -> list[np.ndarray]:
        """Slice a whole utterance into chunk-sized sample blocks,
        validating the chunk contract."""
        samples = np.asarray(samples, self.np_dtype)
        cs = self.cfg.chunk_samples
        if samples.ndim != 1 or samples.size == 0 or samples.size % cs:
            raise ValueError(
                f"audio stream must be a non-empty 1-D array with a "
                f"multiple of {cs} samples (= whole "
                f"{self.cfg.rows}x{self.cfg.cols} chunks), got shape "
                f"{samples.shape}")
        return [samples[i * cs:(i + 1) * cs]
                for i in range(samples.size // cs)]

    def offline_features(self, samples) -> torch.Tensor:
        """Whole-utterance features [n_chunks * F_c, d_model]: the same
        per-chunk function the streaming path runs, chained over every
        chunk with the FIR carry threaded through."""
        carry = self.init_state()
        feats = []
        for chunk in self.split(samples):
            carry, f = self.chunk_features(carry, chunk)
            feats.append(f)
        return torch.cat(feats, dim=0)


def synth_samples(fc: FrontendConfig, n_chunks: int,
                  seed: int = 0) -> np.ndarray:
    """Deterministic synthesized utterance of ``n_chunks`` whole chunks."""
    rng = np.random.default_rng(seed)
    n = n_chunks * fc.chunk_samples
    if fc.dtype == "int16":
        return rng.integers(-8, 8, n).astype(np.int16)
    return (rng.standard_normal(n) * 0.5).astype(np.float32)
