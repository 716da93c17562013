"""Synthetic datasets: planted-structure solver inputs + warped patch pairs.

Port of ``opencv_dlco_tpu/data/synthetic.py``. The numpy functions are
copies, so both packages draw the same data from the same numpy seed:

- ``synth_pr_dataset`` / ``synth_pj_dataset``: distance / difference
  matrices with a planted informative structure the PR / PJ solvers must
  recover;
- ``synth_patch_pairs``: uint8 patch pairs where positives are warped +
  noised copies — drives the stage-1..3 descriptor/distance path;
- ``render_blob_sequence``: a rendered closed-loop monocular sequence, the
  SLAM benchmark scene;
- ``brown_like_pr_splits``: stage-3 ring-distance splits shaped like the
  real Brown training matrices.

``synth_patch_pairs_device`` draws the same pair distribution on the card
with torch (distribution-equivalent to ``synth_patch_pairs``, not
bit-equal: another random stream and f32 FFTs).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def synth_pr_dataset(rng: np.random.Generator, *, n_pos=2000, n_neg=2000,
                     n_feat=256, n_informative=16, sep=1.5):
    """Ring-distance-like matrices (pos, neg, informative_idx)."""
    info = rng.choice(n_feat, size=n_informative, replace=False)
    pos = np.abs(rng.normal(1.0, 0.5, size=(n_pos, n_feat))).astype(np.float32)
    neg = np.abs(rng.normal(1.0, 0.5, size=(n_neg, n_feat))).astype(np.float32)
    pos[:, info] = np.abs(rng.normal(0.3, 0.15, size=(n_pos, n_informative)))
    neg[:, info] = np.abs(rng.normal(0.3 + sep, 0.5, size=(n_neg, n_informative)))
    return pos.astype(np.float32), neg.astype(np.float32), info


def synth_pj_dataset(rng: np.random.Generator, *, n_pos=1500, n_neg=1500,
                     n_feat=64, n_subspace=8, sep=2.0):
    """Signed descriptor-difference vectors (pos, neg, subspace_basis)."""
    basis = np.linalg.qr(rng.normal(size=(n_feat, n_feat)))[0]
    sub = basis[:, :n_subspace]
    pos = rng.normal(0.0, 0.3, size=(n_pos, n_feat))
    neg = rng.normal(0.0, 0.3, size=(n_neg, n_feat))
    neg += rng.normal(0.0, sep, size=(n_neg, n_subspace)) @ sub.T
    return pos.astype(np.float32), neg.astype(np.float32), sub


def _smooth(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Band-limited random images in [0, 1] (pure white noise has degenerate
    gradient statistics)."""
    freq = rng.normal(size=(n, size, size)) + 1j * rng.normal(size=(n, size, size))
    fy = np.fft.fftfreq(size)[None, :, None]
    fx = np.fft.fftfreq(size)[None, None, :]
    mask = np.exp(-((fx ** 2 + fy ** 2) * (size / 4.0) ** 2))
    img = np.fft.ifft2(freq * mask).real
    lo = img.min(axis=(1, 2), keepdims=True)
    hi = img.max(axis=(1, 2), keepdims=True)
    return (img - lo) / (hi - lo + 1e-9)


def render_blob_sequence(rng: np.random.Generator, n_frames: int = 48,
                         *, size: int = 256, f: float = 300.0,
                         n_blobs: int = 240, radius: float = 1.5,
                         closed_loop: bool = True
                         ) -> Tuple[list, np.ndarray, Tuple[float, float, float, float]]:
    """Rendered monocular sequence over a 3D Gaussian-blob field.

    Camera follows a circle in the x-y plane (closing the loop when
    ``closed_loop``), looking down +z — the SLAM benchmark scene (loop
    closures are detectable, not injected). Vectorised splatting (one
    (H*W, B) exp per frame) so rendering never dominates a benchmark run.

    Returns (frames [uint8 (size, size)], gt camera centers (F, 3),
    intrinsics (fx, fy, cx, cy)).
    """
    c = size / 2.0
    pts3d = np.stack([
        rng.uniform(-4, 4, n_blobs), rng.uniform(-4, 4, n_blobs),
        rng.uniform(5, 12, n_blobs)
    ], 1)
    amps = (rng.uniform(0.4, 1.0, n_blobs)
            * rng.choice([-1, 1], n_blobs)).astype(np.float32)
    sigmas = rng.uniform(2.0, 4.0, n_blobs).astype(np.float32)
    inv2s2 = (1.0 / (2.0 * sigmas ** 2)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    span = 2 * np.pi if closed_loop else np.pi
    frames, centers = [], []
    for i in range(n_frames):
        th = span * i / n_frames
        center = np.array([radius * (np.cos(th) - 1.0),
                           radius * np.sin(th), 0.0])
        yaw = 0.03 * np.sin(th)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        r = r_wc.T                      # world -> cam
        t = -r @ center
        p = pts3d @ r.T + t
        u = (f * p[:, 0] / p[:, 2] + c).astype(np.float32)
        v = (f * p[:, 1] / p[:, 2] + c).astype(np.float32)
        vis = ((u > -10) & (u < size + 10) & (v > -10) & (v < size + 10)
               & (p[:, 2] > 0.1))
        d2 = ((yy[:, :, None] - v[vis]) ** 2
              + (xx[:, :, None] - u[vis]) ** 2)
        img = np.einsum("hwb,b->hw", np.exp(-d2 * inv2s2[vis]), amps[vis])
        img = (img - img.min()) / (img.max() - img.min() + 1e-12)
        frames.append((img * 255).astype(np.uint8))
        centers.append(center)
    return frames, np.stack(centers), (f, f, c, c)


def _warp_bilinear(imgs: np.ndarray, dy, dx, angle, scale,
                   out_size: int) -> np.ndarray:
    """Batched similarity warp + crop: (N, H, W) -> (N, out, out).

    Inverse-mapped bilinear sampling about the image centre (rotate by
    ``angle``, scale by ``scale``, then translate by (dy, dx)); fully
    vectorised so pair generation never dominates a benchmark run."""
    n, h, w = imgs.shape
    yy, xx = np.mgrid[:out_size, :out_size].astype(np.float64)
    yc = yy - (out_size - 1) / 2.0
    xc = xx - (out_size - 1) / 2.0
    cos = np.cos(angle)[:, None, None]
    sin = np.sin(angle)[:, None, None]
    inv_s = 1.0 / scale[:, None, None]
    sy = (cos * yc + sin * xc) * inv_s + (h - 1) / 2.0 + dy[:, None, None]
    sx = (-sin * yc + cos * xc) * inv_s + (w - 1) / 2.0 + dx[:, None, None]
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 2)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 2)
    fy = np.clip(sy - y0, 0.0, 1.0)
    fx = np.clip(sx - x0, 0.0, 1.0)
    b = np.arange(n)[:, None, None]
    v00 = imgs[b, y0, x0]
    v01 = imgs[b, y0, x0 + 1]
    v10 = imgs[b, y0 + 1, x0]
    v11 = imgs[b, y0 + 1, x0 + 1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def synth_patch_pairs_device(n_pairs: int, patch_size: int = 64,
                             pos_frac: float = 0.5, noise: float = 0.06,
                             shift: int = 2, rot: float = 0.0,
                             scale_jitter: float = 0.0,
                             contrast_jitter: float = 0.0,
                             neg_overlap: float = 0.0, *,
                             generator: torch.Generator, device="cuda"
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``synth_patch_pairs`` on the device: the same generative math
    (band-limited FFT textures, similarity-warped positives, blended hard
    negatives, photometric jitter, noise), drawn from ``generator`` (a
    ``torch.Generator`` on ``device``). Only the uint8 patches leave the
    device.

    Distribution-equivalent to the numpy route, not bit-equal (another
    random stream, f32 FFTs); a fixed seed gives the same bits on one
    device. Every draw takes the warp route of the JAX package's device
    program (``opencv_dlco_tpu/data/synthetic.py:170-274``): a margin that
    covers the worst-case warp, continuous shifts, and identity warps as a
    static centre crop.

    Returns (patches1, patches2, labels) as numpy arrays, positives first:
    the ``synth_patch_pairs`` contract.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"synth_patch_pairs_device(device={device!r}): "
                           f"CUDA is not available; pass device='cpu'")
    g = generator
    n_pos = int(n_pairs * pos_frac)
    n_neg = n_pairs - n_pos
    margin = shift + int(np.ceil(
        0.5 * patch_size * (np.sin(rot) + scale_jitter))) + 1
    size = patch_size + 2 * margin

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev)

    base = _smooth_device(normal, n_pairs + n_neg, size, dev)
    p1 = base[:n_pairs, margin:margin + patch_size,
              margin:margin + patch_size]
    dy = uniform((n_pairs,), -shift, shift)
    dx = uniform((n_pairs,), -shift, shift)
    ang = uniform((n_pairs,), -rot, rot)
    sc = (torch.exp(uniform((n_pairs,), -np.log1p(scale_jitter),
                            np.log1p(scale_jitter)))
          if scale_jitter > 0 else torch.ones(n_pairs, device=dev))
    p2 = _warp_device(base[:n_pairs], dy, dx, ang, sc, patch_size)
    others = base[n_pairs:, margin:margin + patch_size,
                  margin:margin + patch_size]
    p2[n_pos:] = neg_overlap * p1[n_pos:] + (1.0 - neg_overlap) * others
    del base, others
    if contrast_jitter > 0.0:
        gain = 1.0 + uniform((n_pairs, 1, 1), -contrast_jitter,
                             contrast_jitter)
        bias = uniform((n_pairs, 1, 1), -0.5 * contrast_jitter,
                       0.5 * contrast_jitter)
        p2 = (p2 - 0.5) * gain + 0.5 + bias
    p1 = p1 + noise * normal(p1.shape)
    p2 = p2 + noise * normal(p2.shape)

    def to_u8(x):
        return (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu().numpy()

    labels = np.zeros(n_pairs, dtype=np.uint8)
    labels[:n_pos] = 1
    return to_u8(p1), to_u8(p2), labels


def _smooth_device(normal, n: int, size: int, dev) -> torch.Tensor:
    """``_smooth`` in f32 on the device: the inverse FFT of complex64
    normals under the Gaussian band mask, scaled to [0, 1] per image."""
    freq = torch.complex(normal((n, size, size)), normal((n, size, size)))
    f1 = torch.fft.fftfreq(size, device=dev, dtype=torch.float32)
    mask = torch.exp(-((f1[:, None] ** 2 + f1[None, :] ** 2)
                       * (size / 4.0) ** 2))
    img = torch.fft.ifft2(freq * mask).real
    del freq
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    return (img - lo) / (hi - lo + 1e-9)


def _warp_device(imgs: torch.Tensor, dy, dx, angle, scale,
                 out_size: int) -> torch.Tensor:
    """``_warp_bilinear`` in f32 on the device: inverse-mapped similarity
    about the centre, bilinear gathers on the flattened images."""
    n, h, w = imgs.shape
    ar = torch.arange(out_size, device=imgs.device, dtype=torch.float32)
    yc = (ar - (out_size - 1) / 2.0)[:, None]
    xc = (ar - (out_size - 1) / 2.0)[None, :]
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    inv_s = 1.0 / scale[:, None, None]
    sy = (cos * yc + sin * xc) * inv_s + (h - 1) / 2.0 + dy[:, None, None]
    sx = (-sin * yc + cos * xc) * inv_s + (w - 1) / 2.0 + dx[:, None, None]
    y0 = torch.clamp(torch.floor(sy).long(), 0, h - 2)
    x0 = torch.clamp(torch.floor(sx).long(), 0, w - 2)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    flat = imgs.reshape(n, h * w)

    def gather(oy, ox):
        idx = ((y0 + oy) * w + (x0 + ox)).reshape(n, -1)
        return torch.gather(flat, 1, idx).reshape(y0.shape)

    return (gather(0, 0) * (1 - fy) * (1 - fx) + gather(0, 1) * (1 - fy) * fx
            + gather(1, 0) * fy * (1 - fx) + gather(1, 1) * fy * fx)


# Hardened pair distribution for precision gating (VERDICT r2 item 2): the
# legacy defaults are so separable that FPR95 = 0 at any matmul precision,
# which makes a |dFPR95| gate vacuous. These knobs put the f32 FPR95 of a
# uniform-pooled descriptor in the 5-20% band of the real Brown task
# (reference: workspace/pr-result-table.txt:7-17), so the bf16 gate can
# actually fail. Calibrated in bench_precision_fpr95.
HARD_PAIR_PARAMS = dict(noise=0.10, shift=5, rot=0.30, scale_jitter=0.18,
                        contrast_jitter=0.35, neg_overlap=0.45)


def synth_patch_pairs(rng: np.random.Generator, n_pairs: int = 256,
                      patch_size: int = 64, pos_frac: float = 0.5,
                      noise: float = 0.06, shift: int = 2,
                      rot: float = 0.0, scale_jitter: float = 0.0,
                      contrast_jitter: float = 0.0, neg_overlap: float = 0.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (patches1, patches2, labels): uint8 (N, P, P) x2 + {0,1} (N,).

    Positives are warped (shift/rotation/scale) + photometrically jittered
    + noised copies of the same base texture; negatives are independent
    textures, optionally blended with the first patch's texture
    (``neg_overlap``) to create hard negatives that share structure. With
    the default zero warp/jitter knobs this reproduces the original easy
    distribution bit-for-bit; ``HARD_PAIR_PARAMS`` is the calibrated hard
    preset used by the precision gates.
    """
    n_pos = int(n_pairs * pos_frac)
    if rot == 0.0 and scale_jitter == 0.0:
        base = _smooth(rng, n_pairs + (n_pairs - n_pos),
                       patch_size + 2 * shift)
        p1 = np.empty((n_pairs, patch_size, patch_size))
        p2 = np.empty((n_pairs, patch_size, patch_size))
        labels = np.zeros(n_pairs, dtype=np.uint8)
        c = shift
        for i in range(n_pairs):
            a = base[i]
            p1[i] = a[c:c + patch_size, c:c + patch_size]
            if i < n_pos:
                dy, dx = rng.integers(-shift, shift + 1, size=2)
                p2[i] = a[c + dy:c + dy + patch_size,
                          c + dx:c + dx + patch_size]
                labels[i] = 1
            else:
                b = base[n_pairs + (i - n_pos)]
                p2[i] = b[c:c + patch_size, c:c + patch_size]
    else:
        # margin covering the worst-case warp so sampling never clamps
        margin = shift + int(np.ceil(
            0.5 * patch_size * (np.sin(rot) + scale_jitter))) + 1
        base = _smooth(rng, n_pairs + (n_pairs - n_pos),
                       patch_size + 2 * margin)
        zero = np.zeros(n_pairs)
        one = np.ones(n_pairs)
        p1 = _warp_bilinear(base[:n_pairs], zero, zero, zero, one,
                            patch_size)
        dy = rng.uniform(-shift, shift, n_pairs)
        dx = rng.uniform(-shift, shift, n_pairs)
        ang = rng.uniform(-rot, rot, n_pairs)
        sc = np.exp(rng.uniform(-np.log1p(scale_jitter),
                                np.log1p(scale_jitter), n_pairs))
        p2 = _warp_bilinear(base[:n_pairs], dy, dx, ang, sc, patch_size)
        labels = np.zeros(n_pairs, dtype=np.uint8)
        labels[:n_pos] = 1
        others = _warp_bilinear(base[n_pairs:], zero[n_pos:], zero[n_pos:],
                                zero[n_pos:], one[n_pos:], patch_size)
        # hard negatives: blend the query texture in, so negatives share
        # low-frequency structure with their query instead of being
        # statistically independent
        p2[n_pos:] = neg_overlap * p1[n_pos:] + (1.0 - neg_overlap) * others
    if contrast_jitter > 0.0:
        gain = 1.0 + rng.uniform(-contrast_jitter, contrast_jitter,
                                 (n_pairs, 1, 1))
        bias = rng.uniform(-0.5 * contrast_jitter, 0.5 * contrast_jitter,
                           (n_pairs, 1, 1))
        p2 = (p2 - 0.5) * gain + 0.5 + bias
    p1 = p1 + rng.normal(0, noise, p1.shape)
    p2 = p2 + rng.normal(0, noise, p2.shape)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
    return to_u8(p1), to_u8(p2), labels


#: Calibrated parameters of `brown_like_ring_distances`. Derivation
#: (round 4, offline calibration sweep): n_info/decay/margin_scale were
#: fit against TWO properties of the published liberty pr-learn logs
#: (data/reference_logs.py) — the best-model NNZ row at mu=0.01 across
#: gamma in {0.005..0.25} and the 10-30% FPR95 band of the real task —
#: then held fixed; tests/test_pr_log_oracle.py asserts on the REMAINING
#: grid points (out-of-sample bracketing + monotonicity).
BROWN_RING_PARAMS = dict(n_feat=1280, n_info=24, decay=-0.4,
                         margin_scale=4.0, base=3.2, noise=1.4,
                         hard_sd=0.45, pos_sd=0.2)


def brown_like_pr_splits(rng: np.random.Generator, n_train: int,
                         n_val: int, params: dict = None):
    """Synthetic stage-3 ring-distance splits statistically shaped like
    the real Brown training matrices (for the PR-solver convergence
    oracle): (pos_trn, neg_trn, pos_val, neg_val), each (n, n_feat) f32.

    Structure (reference: src/comp-fulldists.cpp:294-356 produces 5120
    ring distances per pair; src/pr-learn.cpp trains on them):

    - a power-law tail of informative rings: ring r's matching/
      non-matching margin is ``margin_scale * (1+r)^decay`` for the
      ``n_info`` informative rings, 0 elsewhere (one ring permutation
      shared by all four splits);
    - a SHARED per-pair hardness factor: both patches of a pair feed
      every ring, so a hard negative (similar-looking patches) sits near
      the matching distribution in EVERY informative ring simultaneously
      — this is what keeps the real task non-separable (FPR95 ~15-20%,
      pr-result-table.txt) and the hinge violations alive at equilibrium.
      Positives carry a small |N(0, pos_sd)| off-margin factor (imperfect
      correspondences).

    Known limitation (documented for the oracle test): real Brown margins
    have a bimodal gap that makes the published NNZ surface flat in mu
    across [0.001, 0.06]; an iid power-law tail reproduces the gamma axis
    (the axis that orders the published surface) but keeps residual mu
    sensitivity at the decade edges.
    """
    p = dict(BROWN_RING_PARAMS)
    if params:
        p.update(params)
    n_feat, n_info = p["n_feat"], p["n_info"]
    margins = np.zeros(n_feat, np.float32)
    idx = rng.permutation(n_feat)[:n_info]
    margins[idx] = (1.0 + np.arange(n_info)) ** p["decay"]

    def draw(n_rows, is_neg):
        if is_neg:
            s = np.clip(rng.normal(1.0, p["hard_sd"], (n_rows, 1)),
                        0.0, None).astype(np.float32)
        else:
            s = np.abs(rng.normal(0.0, p["pos_sd"],
                                  (n_rows, 1))).astype(np.float32)
        d = rng.normal(p["base"], p["noise"],
                       size=(n_rows, n_feat)).astype(np.float32)
        return np.abs(d + margins * (p["margin_scale"] * s))

    return (draw(n_train, False), draw(n_train, True),
            draw(n_val, False), draw(n_val, True))
