"""Headless model visualization (port of ``privacy_preserving_sfm_tpu/
viz``): PNG renders (``render``, through matplotlib, imported only when a
PNG is drawn) and a self-contained interactive HTML viewer
(``interactive``, numpy only).  ``render_model`` and ``render_turntable``
load ``render`` on first use, so importing this package, or the HTML
path, imports no matplotlib."""


def render_model(*args, **kwargs):
    from privacy_preserving_sfm_torch.viz import render

    return render.render_model(*args, **kwargs)


def render_turntable(*args, **kwargs):
    from privacy_preserving_sfm_torch.viz import render

    return render.render_turntable(*args, **kwargs)
