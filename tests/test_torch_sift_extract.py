"""Port parity for the whole ``extract_sift`` in its dense modes.

The same numpy image goes through both packages' SIFT on the CPU in the
four ``dense_half_res`` x ``dense_bf16`` settings (a blob image in the
default one is in ``test_torch_sift_modes.py``).  The two pyramids differ
by float32 convolution order (about 4e-7), which can flip a borderline
extremum or move a near-singular refinement, and a flipped keypoint moves
the rank of every keypoint below it; so keypoints are held as sets, by
the shares in ``BARS`` (``check_extract_sift``).
"""

import pytest
import torch
from torch_sift_cases import check_extract_sift, ref  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["half_bf16", "full_bf16", "half_f32",
                                  "full_f32"])
def test_extract_sift_matches_reference(ref, mode):
    check_extract_sift(ref, mode, "texture")
