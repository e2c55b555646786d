"""TSN-style segment samplers, vectorised: the port's own copy of
`ta3n_tpu/data/samplers.py`.

Behavioural parity with the reference samplers (dataset.py:76-116), but
0-based (the reference's ``offsets + 1`` is file-naming, img_00001.t7) and
vectorised over the whole batch so sampling is one numpy call per batch
instead of a Python loop per video.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_indices_random", "sample_indices_val",
           "sample_indices_test", "expand_new_length"]


def sample_indices_random(num_frames: np.ndarray, num_segments: int,
                          new_length: int, rng: np.random.Generator
                          ) -> np.ndarray:
    """Training sampler: random offset inside each of S equal chunks.

    Parity: dataset.py:76-90.  num_frames: [B] ints; returns [B, S] 0-based.
    """
    num_frames = np.asarray(num_frames)
    b = num_frames.shape[0]
    avg = (num_frames - new_length + 1) // num_segments  # [B]
    base = np.arange(num_segments)[None, :] * avg[:, None]
    # randint(avg) per segment; avoid zero modulus by clamping then masking
    r = rng.integers(0, np.maximum(avg, 1)[:, None],
                     size=(b, num_segments))
    case1 = base + r

    # elif num_frames > num_segments: sorted randint(n - new_length + 1)
    hi = np.maximum(num_frames - new_length + 1, 1)
    case2 = np.sort(rng.integers(0, hi[:, None], size=(b, num_segments)),
                    axis=1)

    zeros = np.zeros((b, num_segments), dtype=np.int64)
    out = np.where((avg > 0)[:, None], case1,
                   np.where((num_frames > num_segments)[:, None], case2,
                            zeros))
    return out.astype(np.int64)


def _central(num_frames: np.ndarray, num_segments: int, new_length: int
             ) -> np.ndarray:
    num_select = num_frames - new_length + 1
    tick = num_select.astype(np.float64) / float(num_segments)
    x = np.arange(num_segments, dtype=np.float64)[None, :]
    return (tick[:, None] / 2.0 + tick[:, None] * x).astype(np.int64)


def sample_indices_val(num_frames: np.ndarray, num_segments: int,
                       new_length: int) -> np.ndarray:
    """Validation sampler: centre of each segment, or zeros if too short.

    Parity: dataset.py:92-101.
    """
    num_frames = np.asarray(num_frames)
    num_min = num_segments + new_length - 1
    central = _central(num_frames, num_segments, new_length)
    zeros = np.zeros_like(central)
    return np.where((num_frames >= num_min)[:, None], central, zeros)


def sample_indices_test(num_frames: np.ndarray, num_segments: int,
                        new_length: int) -> np.ndarray:
    """Test sampler: centre of segment; short videos enumerate all frames
    then repeat the last one.

    Parity: dataset.py:103-116 including the short-video branch
    (``id_expand`` duplicates ``id_select[id_select[0]-1]`` — index -1, the
    last enumerated frame).
    """
    num_frames = np.asarray(num_frames)
    num_min = num_segments + new_length - 1
    central = _central(num_frames, num_segments, new_length)

    num_select = np.maximum(num_frames - new_length + 1, 1)
    pos = np.arange(num_segments)[None, :]
    short = np.minimum(pos, num_select[:, None] - 1)

    return np.where((num_frames >= num_min)[:, None], central, short)


def expand_new_length(indices: np.ndarray, num_frames: np.ndarray,
                      new_length: int) -> np.ndarray:
    """Expand [B, S] segment starts to [B, S*new_length] frame indices.

    Parity: dataset.py:128-144 — per start p, take new_length consecutive
    frames, incrementing only while p < num_frames (clamps at the last
    frame).
    """
    if new_length == 1:
        return indices
    steps = np.arange(new_length)[None, None, :]
    frames = indices[:, :, None] + steps
    frames = np.minimum(frames, (num_frames - 1)[:, None, None])
    b, s, _ = frames.shape
    return frames.reshape(b, s * new_length)
