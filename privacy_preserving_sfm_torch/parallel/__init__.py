"""Sharded matching and point-sharded bundle adjustment on
``torch.distributed`` (port of ``privacy_preserving_sfm_tpu/parallel``).

The reference framework is single-process (``src/util/threading.h``
thread pools); this package, as its reference does, adds the
distributed path: matching split over image pairs (no collective), and
BA with points sharded over ranks, cameras replicated and the camera
system summed with one all-reduce a CG step.  One rank per process, each
on its own device; a process group stands for the reference's mesh.
"""
