"""Port parity for SIFT's gather stage: the gather, affine-shape and DSP
modes against the reference package.

Each stage runs on the reference's own Gaussian levels and DoG and agrees
as ``check_octave_features`` states; ``extract_sift`` in each mode, and on
a blob image in the default mode, is held by ``check_extract_sift``
(keypoint sets, ``BARS``).
"""

import pytest
import torch
from torch_sift_cases import (  # noqa: F401  (ref, octaves: fixtures)
    check_extract_sift, check_octave_features, octaves, ref,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["gather", "affine", "dsp"])
def test_gather_stage_matches_reference(ref, octaves, mode):
    check_octave_features(ref, octaves, mode, 1)


@pytest.mark.parametrize("mode,kind", [
    ("gather", "texture"), ("affine", "texture"), ("dsp", "texture"),
    ("half_bf16", "blob")])
def test_extract_sift_matches_reference(ref, mode, kind):
    check_extract_sift(ref, mode, kind)
