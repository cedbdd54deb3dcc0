"""SQLite database, schema-compatible with the reference.

Numpy/sqlite3 host code carried over verbatim from
``privacy_preserving_sfm_tpu/models/database.py``, with the camera model
registry taken from the port's ``ops/cameras.py``: a database written by
either package reads identically in the other.

Tables and blob layouts match ``src/base/database.cc:924-1000``:

  cameras             (camera_id, model, width, height, params f64 blob,
                       prior_focal_length)
  images              (image_id, name, camera_id, prior_q*, prior_t*)
  descriptors         (image_id, rows, cols, uint8 blob)
  matches             (pair_id, rows, cols, uint32[N,2] blob)
  line_features       (image_id, rows, cols, float32[N,4] blob:
                       a, b, c, is_aligned — ``database.cc:55-74``)
  gravity_directions  (image_id, x, y, z)

Pair ids pack as ``kMaxNumImages * min + max`` with column swap on read when
image_id1 > image_id2 (``database.cc:311-332``).  Lines are renormalized on
read exactly like the reference.  No keypoints table is ever written by the
pipeline — the privacy property.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from privacy_preserving_sfm_torch.ops.cameras import MODELS, MODEL_BY_ID

MAX_NUM_IMAGES = 2147483647  # int32 max (database.cc:229)


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return MAX_NUM_IMAGES * image_id1 + image_id2


def pair_id_to_image_pair(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_NUM_IMAGES
    image_id1 = pair_id // MAX_NUM_IMAGES
    return image_id1, image_id2


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras
   (camera_id            INTEGER  PRIMARY KEY AUTOINCREMENT  NOT NULL,
    model                INTEGER                             NOT NULL,
    width                INTEGER                             NOT NULL,
    height               INTEGER                             NOT NULL,
    params               BLOB,
    prior_focal_length   INTEGER                             NOT NULL);
CREATE TABLE IF NOT EXISTS images
   (image_id   INTEGER  PRIMARY KEY AUTOINCREMENT  NOT NULL,
    name       TEXT                                NOT NULL UNIQUE,
    camera_id  INTEGER                             NOT NULL,
    prior_qw   REAL,
    prior_qx   REAL,
    prior_qy   REAL,
    prior_qz   REAL,
    prior_tx   REAL,
    prior_ty   REAL,
    prior_tz   REAL,
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS descriptors
   (image_id  INTEGER  PRIMARY KEY  NOT NULL,
    rows      INTEGER               NOT NULL,
    cols      INTEGER               NOT NULL,
    data      BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches
   (pair_id  INTEGER  PRIMARY KEY  NOT NULL,
    rows     INTEGER               NOT NULL,
    cols     INTEGER               NOT NULL,
    data     BLOB);
CREATE TABLE IF NOT EXISTS line_features
   (image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS gravity_directions
   (image_id INTEGER PRIMARY KEY NOT NULL,
    x REAL,
    y REAL,
    z REAL);
"""


class Database:
    """Thin sqlite3 wrapper with reference-compatible blob handling."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.conn.commit()
        self.conn.close()

    # -- cameras ---------------------------------------------------------

    def write_camera(self, model: str, width: int, height: int,
                     params: np.ndarray, prior_focal: bool = False,
                     camera_id: Optional[int] = None) -> int:
        model_id = MODELS[model].model_id
        blob = np.asarray(params, np.float64).tobytes()
        cur = self.conn.execute(
            "INSERT INTO cameras(camera_id, model, width, height, params,"
            " prior_focal_length) VALUES(?, ?, ?, ?, ?, ?);",
            (camera_id, model_id, width, height, blob, int(prior_focal)))
        return cur.lastrowid

    def read_cameras(self) -> Dict[int, dict]:
        out = {}
        for cid, model_id, w, h, blob, prior in self.conn.execute(
                "SELECT camera_id, model, width, height, params,"
                " prior_focal_length FROM cameras;"):
            out[cid] = {
                "model": MODEL_BY_ID[model_id].name,
                "width": w,
                "height": h,
                "params": np.frombuffer(blob, np.float64).copy(),
                "prior_focal_length": bool(prior),
            }
        return out

    # -- images ----------------------------------------------------------

    def write_image(self, name: str, camera_id: int,
                    prior_q=None, prior_t=None,
                    image_id: Optional[int] = None) -> int:
        q = [None] * 4 if prior_q is None else list(map(float, prior_q))
        t = [None] * 3 if prior_t is None else list(map(float, prior_t))
        cur = self.conn.execute(
            "INSERT INTO images(image_id, name, camera_id, prior_qw,"
            " prior_qx, prior_qy, prior_qz, prior_tx, prior_ty, prior_tz)"
            " VALUES(?, ?, ?, ?, ?, ?, ?, ?, ?, ?);",
            (image_id, name, camera_id, *q, *t))
        return cur.lastrowid

    def read_images(self) -> Dict[int, dict]:
        out = {}
        for row in self.conn.execute(
                "SELECT image_id, name, camera_id FROM images;"):
            out[row[0]] = {"name": row[1], "camera_id": row[2]}
        return out

    # -- descriptors -----------------------------------------------------

    def write_descriptors(self, image_id: int, descriptors: np.ndarray):
        d = np.ascontiguousarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors(image_id, rows, cols, data)"
            " VALUES(?, ?, ?, ?);",
            (image_id, d.shape[0], d.shape[1], d.tobytes()))

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id = ?;",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 128), np.uint8)
        r, c, blob = row
        return np.frombuffer(blob, np.uint8).reshape(r, c).copy()

    def count_descriptors(self, image_id: int) -> int:
        row = self.conn.execute(
            "SELECT rows FROM descriptors WHERE image_id = ?;",
            (image_id,)).fetchone()
        return 0 if row is None else int(row[0])

    def exists_descriptors(self, image_id: int) -> bool:
        return self.conn.execute(
            "SELECT 1 FROM descriptors WHERE image_id = ?;",
            (image_id,)).fetchone() is not None

    # -- line features + gravity ----------------------------------------

    def write_lines(self, image_id: int, lines: np.ndarray,
                    aligned: np.ndarray):
        blob = np.concatenate(
            [np.asarray(lines, np.float32),
             np.asarray(aligned, np.float32)[:, None]], axis=1)
        blob = np.ascontiguousarray(blob, np.float32)
        self.conn.execute(
            "INSERT OR REPLACE INTO line_features(image_id, rows, cols, data)"
            " VALUES(?, ?, ?, ?);",
            (image_id, blob.shape[0], 4, blob.tobytes()))

    def read_lines(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (lines (N,3) float64 renormalized, aligned (N,) bool)."""
        row = self.conn.execute(
            "SELECT rows, cols, data FROM line_features WHERE image_id = ?;",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 3)), np.zeros((0,), bool)
        r, c, blob = row
        data = np.frombuffer(blob, np.float32).reshape(r, c).astype(np.float64)
        lines = data[:, :3]
        # Renormalize on read (database.cc:64-74).
        n = np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
        lines = lines / np.maximum(n, 1e-12)
        return lines, data[:, 3] > 0

    def exists_lines(self, image_id: int) -> bool:
        return self.conn.execute(
            "SELECT 1 FROM line_features WHERE image_id = ?;",
            (image_id,)).fetchone() is not None

    def write_gravity(self, image_id: int, gravity: np.ndarray):
        g = np.asarray(gravity, np.float64)
        self.conn.execute(
            "INSERT OR REPLACE INTO gravity_directions(image_id, x, y, z)"
            " VALUES(?, ?, ?, ?);", (image_id, g[0], g[1], g[2]))

    def read_gravity(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT x, y, z FROM gravity_directions WHERE image_id = ?;",
            (image_id,)).fetchone()
        return None if row is None else np.asarray(row, np.float64)

    # -- matches ---------------------------------------------------------

    def write_matches(self, image_id1: int, image_id2: int,
                      matches: np.ndarray):
        """matches: (N, 2) uint32 line indices (idx-in-1, idx-in-2)."""
        m = np.ascontiguousarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()  # swap like the reference write path
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        self.conn.execute(
            "INSERT OR REPLACE INTO matches(pair_id, rows, cols, data)"
            " VALUES(?, ?, ?, ?);",
            (pair_id, m.shape[0], 2, m.tobytes()))

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id = ?;",
            (pair_id,)).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        r, c, blob = row
        m = np.frombuffer(blob, np.uint32).reshape(r, c).copy()
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        return m

    def read_all_matches(self) -> Dict[Tuple[int, int], np.ndarray]:
        out = {}
        for pair_id, r, c, blob in self.conn.execute(
                "SELECT pair_id, rows, cols, data FROM matches;"):
            if r == 0:
                continue
            m = np.frombuffer(blob, np.uint32).reshape(r, c).copy()
            out[pair_id_to_image_pair(pair_id)] = m
        return out

    def exists_matches(self, image_id1: int, image_id2: int) -> bool:
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        return self.conn.execute(
            "SELECT 1 FROM matches WHERE pair_id = ?;",
            (pair_id,)).fetchone() is not None

    def commit(self):
        self.conn.commit()
