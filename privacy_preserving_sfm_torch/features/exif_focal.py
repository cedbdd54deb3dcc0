"""EXIF focal-length guessing for images without explicit calibration.

Copy of ``privacy_preserving_sfm_tpu/features/exif_focal.py``.  Mirror of
the reference's prior-focal cascade (``src/util/bitmap.cc:286-370``
``Bitmap::ExifFocalLength`` feeding ``image_reader.cc:117-139``):

1. ``FocalLengthIn35mmFilm``  ->  f_px = f35 / 35.0 * max(W, H)
2. ``FocalLength`` (mm) + sensor width from the camera database
   ->  f_px = f_mm / sensor_width_mm * max(W, H)
3. ``FocalLength`` (mm) + ``FocalPlaneXResolution`` / ``PixelXDimension``
   (CCD width derived from EXIF itself)
4. fallback:  f_px = default_focal_length_factor * max(W, H), and the
   camera is marked as having NO prior focal (BA may refine it).

Sensor widths come from ``features/sensor_db.py`` (a ~1.8k-entry
make/model table with the reference ``camera_database.cc`` lookup
semantics); the small family table below is the last-resort fallback for
models absent from the database but whose name carries a family or
sensor-format hint.

EXIF tags are read through PIL.  Where PIL is not installed the read
fails as any unreadable file does, and the cascade returns the heuristic
focal length with ``has_prior`` False.
"""

from __future__ import annotations

from typing import Optional, Tuple

from privacy_preserving_sfm_torch.features import sensor_db

# Lower-cased "make model" substring -> sensor width in mm.  Ordered dict
# semantics: first match wins; more specific entries must come first.
SENSOR_WIDTHS_MM = (
    # Phone families.
    ("iphone 15 pro", 9.8),
    ("iphone 14 pro", 9.8),
    ("iphone 13 pro", 9.5),
    ("iphone", 7.0),
    ("pixel 8 pro", 9.8),
    ("pixel 7 pro", 9.8),
    ("pixel", 7.4),
    ("galaxy s2", 9.0),
    ("galaxy", 7.3),
    # Interchangeable-lens formats by body naming conventions.
    ("canon eos 5d", 36.0),
    ("canon eos 6d", 35.8),
    ("canon eos r", 36.0),
    ("canon eos", 22.3),        # APS-C bodies
    ("nikon d8", 35.9),
    ("nikon d7", 23.5),
    ("nikon z", 35.9),
    ("nikon", 23.5),
    ("sony ilce-7", 35.8),
    ("sony ilce", 23.5),
    ("sony dsc-rx100", 13.2),
    ("fujifilm x", 23.5),
    ("olympus", 17.3),
    ("panasonic dmc-g", 17.3),
    # Action / drone.
    ("gopro", 6.17),
    ("dji", 6.17),
    # Generic compact fallback by sensor-type naming.
    ("1/2.3", 6.17),
    ("1/1.7", 7.6),
)

DEFAULT_FOCAL_LENGTH_FACTOR = 1.2  # image_reader.h default


def query_sensor_width(make: str, model: str) -> Optional[float]:
    """Sensor width (mm) for a camera make/model, or None if unknown.

    Exact/longest make+model lookup in the sensor database first
    (``sensor_db.query_sensor_width``), then the coarse family-substring
    table above as a fallback.
    """
    width = sensor_db.query_sensor_width(make, model)
    if width is not None:
        return width
    key = f"{make} {model}".lower()
    for sub, width in SENSOR_WIDTHS_MM:
        if sub in key:
            return width
    return None


def _as_float(v) -> Optional[float]:
    """EXIF rational/str/number -> float (PIL returns IFDRational)."""
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def exif_focal_length(image_path: str, width: int,
                      height: int) -> Tuple[float, bool]:
    """(focal_px, has_prior): the reference's ExifFocalLength cascade.

    ``has_prior`` False means the fallback heuristic was used and the
    focal length should be treated as refinable (``prior_focal_length=0``
    in the database).
    """
    max_size = float(max(width, height))
    tags = {}
    try:
        from PIL import ExifTags, Image

        with Image.open(image_path) as im:
            exif = im.getexif()
            tags.update(dict(exif))
            try:
                tags.update(dict(exif.get_ifd(ExifTags.IFD.Exif)))
            except Exception:
                pass
    except Exception:
        tags = {}

    # 1. 35mm-equivalent focal length (tag 41989).
    f35 = _as_float(tags.get(41989))
    if f35 and f35 > 0:
        return f35 / 35.0 * max_size, True

    # 2. Focal length in mm (tag 37386) + sensor width lookup.
    f_mm = _as_float(tags.get(37386))
    if f_mm and f_mm > 0:
        make = str(tags.get(271, "")).strip()
        model = str(tags.get(272, "")).strip()
        sensor = query_sensor_width(make, model)
        if sensor:
            return f_mm / sensor * max_size, True

        # 3. CCD width from FocalPlaneXResolution (41486) +
        #    PixelXDimension (40962) + FocalPlaneResolutionUnit (41488).
        x_res = _as_float(tags.get(41486))
        pix_x = _as_float(tags.get(40962))
        unit = tags.get(41488)
        if x_res and x_res > 0 and pix_x and pix_x > 0:
            ccd_width = pix_x / x_res  # in resolution units
            if unit == 3:  # cm
                return f_mm / (ccd_width * 10.0) * max_size, True
            if unit == 2:  # inches
                return f_mm / (ccd_width * 25.4) * max_size, True

    # 4. Heuristic fallback (image_reader.cc:117-127).
    return DEFAULT_FOCAL_LENGTH_FACTOR * max_size, False
