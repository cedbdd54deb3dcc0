"""PyTorch/CUDA port of the privacy-preserving Structure-from-Motion engine.

A second implementation beside ``privacy_preserving_sfm_tpu`` (the TPU
reference), written for NVIDIA Hopper: plain tensor code is PyTorch, and
the reference's TPU kernels become CUDA C++ kernels in ``kernels/``,
built on first use.  The package never imports the reference
or its array framework.

Ported so far: the ``bundle_adjuster`` slice, i.e. the mapper's global
bundle adjustment on the explicit-Schur SoA solver (``optim/ba_soa.py``)
with hand-written Schur Gram and PCG kernels; and the matcher slice, i.e.
the database, the exhaustive, sequential, spatial and transitive
matchers and the matches importer (``features/``) with a hand-written
top-2 match kernel.
"""

__version__ = "0.1.0"
