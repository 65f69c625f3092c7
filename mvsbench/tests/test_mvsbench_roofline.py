"""The kernels' byte and operation counts against hand counts at small
shapes, and the peaks they are divided by."""

import pytest
import torch

from mvsbench.roofline import (FP32_FLOPS_PER_S, HBM_BYTES_PER_S,
                               existing_neighbours, k1, k2, k3,
                               least_seconds)


def test_peaks_and_least_seconds():
    assert HBM_BYTES_PER_S == 3.35e12 and FP32_FLOPS_PER_S == 67e12
    assert least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert least_seconds(1.0, 67e12) == pytest.approx(1.0)


def test_existing_neighbours():
    assert existing_neighbours(3, (-1, 1)) == [1, 2, 1]
    assert existing_neighbours(1, (-1, 1)) == [0]
    assert existing_neighbours(4, (-2, -1, 1, 2)) == [2, 3, 3, 2]


def test_k1_hand_count():
    # 3 frames of 2x4; 5 valid pixels in frame 0, 8 in 1, 0 in 2
    d = torch.zeros(3, 2, 4)
    d[0].view(-1)[:5] = 0.5
    d[1] = 0.5
    d[2] = 7.0                                # out of [0.1, 1]: invalid
    n_bytes = 8 * 3 * 2 * 4 + 84 * 3          # 444
    flops = 25 * 13 + 88 * (5 * 1 + 8 * 2)    # 325 + 1848
    assert k1.bound(d, 0.1, 1.0) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12))


def test_k2_hand_count():
    # 2 frames of 4x4, stride 2: 4 samples a frame; every pixel is a sample
    # or one of a sample's four wrapped neighbours except (1,1), (1,3),
    # (3,1), (3,3)
    n_bytes = 4 * 2 * 16 + 96 * 2 + 29 * 2 * 4
    votes = 4 * (1 + 1)                       # nbr_num 1: one neighbour each
    flops = 25 * 2 * 12 + 32 * 2 * 4 + 32 * votes
    assert k2.bound(2, 4, 4, 2, 1, 1) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12))


def test_k3_hand_count():
    # one frame 4x4, two faces: one whose bbox is 2x3 pixels, one culled
    uvz = torch.tensor([[[0.2, 0.4, 1.0], [1.6, 0.4, 1.0], [0.2, 2.5, 1.0],
                         [9.0, 9.0, 1.0]]])
    faces = torch.tensor([[0, 1, 2], [0, 1, 3]], dtype=torch.int32)
    ok = torch.tensor([[True, False]])
    # bbox x [0, 2], y [0, 3] -> 3 x 4 = 12 pixels
    n_bytes = 12 * 4 + 6 * 4 + 2 + 16 * 4
    flops = 40 * 1 + 15 * 12
    assert k3.bound(uvz, faces, ok, 4, 4) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12))
