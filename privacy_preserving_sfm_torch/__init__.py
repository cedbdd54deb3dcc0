"""PyTorch/CUDA port of the privacy-preserving Structure-from-Motion engine.

A second implementation beside ``privacy_preserving_sfm_tpu`` (the TPU
reference), written for NVIDIA Hopper: plain tensor code is PyTorch, and
the reference's TPU kernels become CUDA C++ kernels in ``kernels/``,
built on first use.  The package never imports the reference
or its array framework.

It does everything the reference package does, with the reference's
module names:

* bundle adjustment (``optim/``): the flat, dense-block and SoA
  explicit-Schur solvers with hand-written Schur Gram and PCG kernels,
  and the variable-intrinsics solver;
* the front end and the matchers (``features/``): SIFT and the line
  lift, the database, the exhaustive, sequential, spatial and
  transitive matchers and the matches importer, with a hand-written
  top-2 match kernel;
* the 4-view line initializer (``init/``), RANSAC with PROSAC and the
  subset prescreen, P6L registration and robust line triangulation
  (``solvers/``), the correspondence graph and database cache
  (``models/``);
* the incremental mapper, its controller and the hierarchical mapper
  (``sfm/``);
* the sharded matcher and the point-sharded bundle adjustment on
  ``torch.distributed``, one rank per process (``parallel/``);
* the model viewer, PNG through matplotlib or a self-contained HTML file
  (``viz/``);
* the ``ppsfm`` CLI's 15 subcommands (``exe/``);
* the evaluation tools of the repository's ``tools/``: the seeded
  dataset renderer and the pose-parity evaluator (``tools/``).
"""

__version__ = "0.1.0"
