"""Clip chunking and frame-sampling index math.

A numpy copy of ``maed_tpu/data/chunks.py`` (the original MAED's
``lib/data_utils/img_utils.py::split_into_chunks`` and the 3 sampling modes of
``lib/dataset/dataset_video.py``).

Pure index computation on host; no skimage dependency (windowing is a stride
trick).
"""

from __future__ import annotations

import numpy as np


def view_as_windows_1d(arr: np.ndarray, window: int, step: int) -> np.ndarray:
    """(L,) -> (num_windows, window) sliding windows with the given step."""
    n = (len(arr) - window) // step + 1
    if n <= 0:
        return np.empty((0, window), dtype=arr.dtype)
    stride = arr.strides[0]
    return np.lib.stride_tricks.as_strided(
        arr, shape=(n, window), strides=(step * stride, stride)
    ).copy()


def split_into_chunks(vid_names: np.ndarray, seqlen: int, stride: int, pad: bool = True):
    """Group frame indices by video, reflect-pad tails to a multiple of seqlen,
    and emit sliding windows of length seqlen with the given stride.

    Returns a list of length-seqlen index lists (frame indices into the DB).
    """
    chunks = []
    video_names, group = np.unique(vid_names, return_index=True)
    perm = np.argsort(group)
    video_names, group = video_names[perm], group[perm]
    indices = np.split(np.arange(0, vid_names.shape[0]), group[1:])

    for idx in range(len(video_names)):
        indexes = indices[idx]
        if pad:
            padlen = (seqlen - indexes.shape[0] % seqlen) % seqlen
            if padlen > 0:
                if indexes.shape[0] == 1:
                    indexes = np.repeat(indexes, seqlen)
                else:
                    indexes = np.pad(indexes, (0, padlen), "reflect")
        if indexes.shape[0] < seqlen:
            continue
        chunks += view_as_windows_1d(indexes, seqlen, stride).tolist()
    return chunks


def gen_sample_index(
    full_sample_idx,
    seqlen: int,
    sample_freq: int,
    random_sample: bool,
    random_start: bool,
    rng: np.random.RandomState | None = None,
):
    """Pick seqlen frames out of a sample_pool window.

    random_sample: one frame uniformly from each of the seqlen buckets.
    random_start:  fixed-stride subsequence from a random phase.
    neither:       deterministic stride (phase 0).
    """
    assert not (random_sample and random_start)
    rng = rng or np.random
    if random_sample:
        sample_idx = [
            full_sample_idx[sample_freq * i + rng.randint(0, sample_freq)]
            for i in range(seqlen)
        ]
    elif random_start:
        start = rng.randint(0, sample_freq)
        sample_idx = list(full_sample_idx[start::sample_freq][:seqlen])
    else:
        sample_idx = list(full_sample_idx[::sample_freq][:seqlen])
    return sample_idx
