"""Gadget raw binary snapshot format (SnapFormat 1 & 2) read/write.

numpy copy of astrild_tpu/io/gadget_binary.py (the JAX package cannot be
imported without JAX); both write byte-identical files. The format is the
one of the reference astrild's rays/voids/tunnels/gadget.py: 256-byte
header in an F77 record, POS/VEL (float32 triplets) and ID blocks, each
wrapped in int32 record markers; SnapFormat 2 precedes every block with a
4-char tag record. Includes format auto-detection and periodic box
selection.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["gadget_header_dtype", "detect_format", "read_gadget",
           "write_gadget", "select_box", "box_overlap",
           "box_fully_contained", "combine_gadget", "read_gadget_multi"]


def gadget_header_dtype():
    return np.dtype([
        ("npart", np.int32, 6),
        ("mass", np.float64, 6),
        ("time", np.float64),
        ("redshift", np.float64),
        ("flag_sfr", np.int32),
        ("flag_feedback", np.int32),
        ("npartTotal", np.uint32, 6),
        ("flag_cooling", np.int32),
        ("num_files", np.int32),
        ("BoxSize", np.float64),
        ("Omega0", np.float64),
        ("OmegaLambda", np.float64),
        ("HubbleParam", np.float64),
        ("fill", "S96"),
    ])


def detect_format(path) -> int:
    """1 or 2 (gadget.py:395-470); raises on non-gadget files."""
    with open(path, "rb") as f:
        first = struct.unpack("i", f.read(4))[0]
    if first == 8:
        return 2  # 8-byte tag record
    if first == 256:
        return 1
    raise ValueError(f"{path}: not a gadget snapshot (lead marker {first})")


def _read_record(f):
    n = struct.unpack("i", f.read(4))[0]
    data = f.read(n)
    n2 = struct.unpack("i", f.read(4))[0]
    if n != n2:
        raise IOError(f"record marker mismatch {n} != {n2}")
    return data


def _skip_tag(f, fmt):
    if fmt == 2:
        _read_record(f)  # 4-char tag + int


def read_gadget(path) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read one gadget file -> (header_record, {'pos','vel','ids','mass'})."""
    fmt = detect_format(path)
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        _skip_tag(f, fmt)
        header = np.frombuffer(_read_record(f), gadget_header_dtype())[0]
        ntot = int(header["npart"].sum())
        _skip_tag(f, fmt)
        out["pos"] = np.frombuffer(_read_record(f), "<f4").reshape(ntot, 3)
        _skip_tag(f, fmt)
        out["vel"] = np.frombuffer(_read_record(f), "<f4").reshape(ntot, 3)
        _skip_tag(f, fmt)
        out["ids"] = np.frombuffer(_read_record(f), "<u4")
        # optional mass block for species with mass==0 in the header —
        # only present when more bytes remain in the file
        needs_mass = int(((header["npart"] > 0)
                          & (header["mass"] == 0)).sum())
        here = f.tell()
        f.seek(0, os.SEEK_END)
        remaining = f.tell() - here
        f.seek(here)
        if needs_mass and remaining >= 8:
            try:
                _skip_tag(f, fmt)
                out["mass"] = np.frombuffer(_read_record(f), "<f4")
            except Exception:
                pass
    return header, out


def _write_record(f, payload: bytes):
    f.write(struct.pack("i", len(payload)))
    f.write(payload)
    f.write(struct.pack("i", len(payload)))


def _write_tag(f, fmt, tag: str, next_size: int):
    if fmt == 2:
        _write_record(f, tag.encode().ljust(4) + struct.pack("i",
                                                             next_size + 8))


def write_gadget(path, pos, vel, ids, boxsize: float, masses=None,
                 mass_table=None, time: float = 1.0, redshift: float = 0.0,
                 omega_m: float = 0.3, omega_l: float = 0.7,
                 hubble: float = 0.7, snap_format: int = 2,
                 part_type: int = 1):
    """Write particles of one species as a gadget snapshot
    (gadget.py:755-855)."""
    pos = np.asarray(pos, "<f4")
    vel = np.asarray(vel, "<f4")
    ids = np.asarray(ids, "<u4")
    n = len(pos)
    hdr = np.zeros((), gadget_header_dtype())
    hdr["npart"][part_type] = n
    hdr["npartTotal"][part_type] = n
    if mass_table is not None:
        hdr["mass"] = mass_table
    hdr["time"] = time
    hdr["redshift"] = redshift
    hdr["num_files"] = 1
    hdr["BoxSize"] = boxsize
    hdr["Omega0"] = omega_m
    hdr["OmegaLambda"] = omega_l
    hdr["HubbleParam"] = hubble
    with open(path, "wb") as f:
        _write_tag(f, snap_format, "HEAD", 256)
        _write_record(f, hdr.tobytes())
        _write_tag(f, snap_format, "POS ", pos.nbytes)
        _write_record(f, pos.tobytes())
        _write_tag(f, snap_format, "VEL ", vel.nbytes)
        _write_record(f, vel.tobytes())
        _write_tag(f, snap_format, "ID  ", ids.nbytes)
        _write_record(f, ids.tobytes())
        if masses is not None:
            m = np.asarray(masses, "<f4")
            _write_tag(f, snap_format, "MASS", m.nbytes)
            _write_record(f, m.tobytes())


def select_box(pos, region, boxsize: float, extra=None):
    """Select particles inside a sub-box with periodic wrap
    (gadget.py:856-970). region: (6,) [x0,x1,y0,y1,z0,z1] — bounds may
    exceed [0, boxsize) to wrap."""
    pos = np.asarray(pos)
    keep = np.ones(len(pos), bool)
    shifted = pos.copy()
    for ax in range(3):
        lo, hi = region[2 * ax], region[2 * ax + 1]
        p = pos[:, ax]
        if lo < 0 or hi > boxsize:
            # wrap into the window frame
            p = (p - lo) % boxsize + lo
            shifted[:, ax] = p
        keep &= (p >= lo) & (p < hi)
    out = [shifted[keep]]
    if extra is not None:
        out += [np.asarray(e)[keep] for e in extra]
    return out if extra is not None else out[0]


def box_overlap(box_a, box_b) -> bool:
    """True when two (6,) [x0,x1,y0,y1,z0,z1] boxes intersect
    (gadget.py boxOverlap)."""
    a = np.asarray(box_a, np.float64)
    b = np.asarray(box_b, np.float64)
    return bool(np.all((a[::2] <= b[1::2]) & (b[::2] <= a[1::2])))


def box_fully_contained(outer, inner) -> bool:
    """True when `inner` lies entirely within `outer`
    (gadget.py boxFullyContained)."""
    o = np.asarray(outer, np.float64)
    i = np.asarray(inner, np.float64)
    return bool(np.all((o[::2] <= i[::2]) & (i[1::2] <= o[1::2])))


def combine_gadget(parts: Sequence[Tuple[np.ndarray, Dict[str, np.ndarray]]]):
    """Concatenate per-file gadget reads into one catalog
    (gadget.py gadgetCombine).

    parts: sequence of (header, blocks) as returned by read_gadget. The
    combined header sums npart; pos/vel/ids (and mass, if every part has
    it) are concatenated in order.
    """
    if not parts:
        raise ValueError("combine_gadget needs at least one part")
    header = np.asarray(parts[0][0]).copy()
    header["npart"] = sum(np.asarray(h["npart"]) for h, _ in parts)
    out: Dict[str, np.ndarray] = {}
    for key in ("pos", "vel", "ids"):
        out[key] = np.concatenate([b[key] for _, b in parts])
    if all("mass" in b for _, b in parts):
        out["mass"] = np.concatenate([b["mass"] for _, b in parts])
    return header, out


def read_gadget_multi(basepath: str):
    """Read a multi-file gadget snapshot `base.0, base.1, ...`
    (gadget.py gadgetMultipleFiles + gadgetCombine). A bare existing
    file reads single-file."""
    if os.path.exists(basepath):
        return read_gadget(basepath)
    parts = []
    i = 0
    while os.path.exists(f"{basepath}.{i}"):
        parts.append(read_gadget(f"{basepath}.{i}"))
        i += 1
    if not parts:
        raise FileNotFoundError(
            f"no gadget file at {basepath} or {basepath}.0")
    return combine_gadget(parts)
