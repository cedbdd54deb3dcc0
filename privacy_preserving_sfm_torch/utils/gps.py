"""GPS coordinate transforms: WGS84 <-> ECEF <-> ENU.

Numpy host code carried over verbatim from
``privacy_preserving_sfm_tpu/utils/gps.py``.

Twin of ``src/util/gps.{h,cc}`` (used by the spatial matcher to turn EXIF
latitude/longitude priors into metric neighbor distances).
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid (gps.h constants).
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2


def ell_to_xyz(lat_deg, lon_deg, alt):
    """Geodetic (deg, deg, m) -> ECEF (m).  Vectorized."""
    lat = np.deg2rad(np.asarray(lat_deg, float))
    lon = np.deg2rad(np.asarray(lon_deg, float))
    alt = np.asarray(alt, float)
    sin_lat = np.sin(lat)
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat ** 2)
    x = (N + alt) * np.cos(lat) * np.cos(lon)
    y = (N + alt) * np.cos(lat) * np.sin(lon)
    z = (N * (1.0 - WGS84_E2) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def xyz_to_ell(xyz):
    """ECEF (m) -> geodetic (deg, deg, m).  Bowring's iteration."""
    xyz = np.asarray(xyz, float)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(8):
        sin_lat = np.sin(lat)
        N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat ** 2)
        alt = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * N / (N + alt)))
    sin_lat = np.sin(lat)
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat ** 2)
    alt = p / np.cos(lat) - N
    return np.stack([np.rad2deg(lat), np.rad2deg(lon), alt], axis=-1)


def ell_to_enu(lat_deg, lon_deg, alt, ref_lat_deg=None, ref_lon_deg=None,
               ref_alt=None):
    """Geodetic -> local ENU around a reference (defaults to the first row).

    Mirror of ``GPSTransform::EllToENU``.
    """
    xyz = ell_to_xyz(lat_deg, lon_deg, alt)
    if ref_lat_deg is None:
        ref = np.atleast_2d(xyz)[0]
        lat0 = np.deg2rad(np.atleast_1d(np.asarray(lat_deg, float))[0])
        lon0 = np.deg2rad(np.atleast_1d(np.asarray(lon_deg, float))[0])
    else:
        ref = ell_to_xyz(ref_lat_deg, ref_lon_deg, ref_alt)
        lat0 = np.deg2rad(ref_lat_deg)
        lon0 = np.deg2rad(ref_lon_deg)
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array([[-so, co, 0.0],
                  [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return (xyz - ref) @ R.T
