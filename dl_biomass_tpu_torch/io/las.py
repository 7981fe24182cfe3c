"""Pure-numpy LAS 1.x point-cloud codec (copied from ``dl_biomass_tpu/io/las.py``).

The reference reads/writes LAS via laspy (``pointcloud_dataloader.py:12-39``,
``downsampling_point_clouds.py:95-125``). laspy is not a dependency of this
framework; this module implements the ASPRS LAS 1.2/1.4 format directly with
vectorized ``np.frombuffer`` decodes — point formats 0-3 and 6-8, bit-field
unpacking, and Extra Bytes VLR support (needed for the ``intensity_normalized``
extra dimension the offline resampler writes).

Read path returns a ``LasData`` with laspy-compatible accessors (``.x``, ``.y``,
``.z`` scaled doubles, ``[name]`` per-dimension arrays, ``dimension_names``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_HDR_FMT_12 = "<4sHH16sBB32s32sHHHLLBHL5L12d"  # through legacy counts + scales/offsets/bounds
# We parse field-by-field instead; sizes: 1.2 header=227, 1.3=235, 1.4=375.

# ---- point record layouts ----------------------------------------------------

# base structured dtypes per point format (names follow laspy conventions)
_FMT_FIELDS: Dict[int, List[Tuple[str, str]]] = {
    0: [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
        ("ret_byte", "u1"), ("raw_classification", "u1"), ("scan_angle_rank", "i1"),
        ("user_data", "u1"), ("point_source_id", "<u2")],
    6: [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
        ("ret_byte", "u1"), ("flags_byte", "u1"), ("raw_classification", "u1"),
        ("user_data", "u1"), ("scan_angle", "<i2"), ("point_source_id", "<u2"),
        ("gps_time", "<f8")],
}
_FMT_FIELDS[1] = _FMT_FIELDS[0] + [("gps_time", "<f8")]
_FMT_FIELDS[2] = _FMT_FIELDS[0] + [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_FMT_FIELDS[3] = _FMT_FIELDS[1] + [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_FMT_FIELDS[7] = _FMT_FIELDS[6] + [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_FMT_FIELDS[8] = _FMT_FIELDS[7] + [("nir", "<u2")]

_STD_SIZES = {0: 20, 1: 28, 2: 26, 3: 34, 6: 30, 7: 36, 8: 38}

# Extra Bytes VLR data_type codes -> numpy dtype
_EB_TYPES = {1: "u1", 2: "i1", 3: "<u2", 4: "<i2", 5: "<u4", 6: "<i4",
             7: "<u8", 8: "<i8", 9: "<f4", 10: "<f8"}
_EB_CODE_FOR = {np.dtype(v.lstrip("<")): k for k, v in _EB_TYPES.items()}


def _bitfield_dims(fmt: int) -> List[Tuple[str, str, int, int]]:
    """(name, source_byte_field, shift, width-in-bits) decoded views."""
    if fmt < 6:
        return [
            ("return_number", "ret_byte", 0, 3),
            ("number_of_returns", "ret_byte", 3, 3),
            ("scan_direction_flag", "ret_byte", 6, 1),
            ("edge_of_flight_line", "ret_byte", 7, 1),
            ("classification", "raw_classification", 0, 5),
            ("synthetic", "raw_classification", 5, 1),
            ("key_point", "raw_classification", 6, 1),
            ("withheld", "raw_classification", 7, 1),
        ]
    return [
        ("return_number", "ret_byte", 0, 4),
        ("number_of_returns", "ret_byte", 4, 4),
        ("synthetic", "flags_byte", 0, 1),
        ("key_point", "flags_byte", 1, 1),
        ("withheld", "flags_byte", 2, 1),
        ("overlap", "flags_byte", 3, 1),
        ("scanner_channel", "flags_byte", 4, 2),
        ("scan_direction_flag", "flags_byte", 6, 1),
        ("edge_of_flight_line", "flags_byte", 7, 1),
        ("classification", "raw_classification", 0, 8),
    ]


@dataclass
class LasHeader:
    version: Tuple[int, int] = (1, 4)
    point_format: int = 6
    scales: np.ndarray = field(default_factory=lambda: np.asarray([0.001] * 3))
    offsets: np.ndarray = field(default_factory=lambda: np.zeros(3))
    point_count: int = 0
    mins: np.ndarray = field(default_factory=lambda: np.zeros(3))
    maxs: np.ndarray = field(default_factory=lambda: np.zeros(3))

    # laspy-style aliases used by the reference's write_las
    @property
    def x_scale(self):
        return self.scales[0]

    @x_scale.setter
    def x_scale(self, v):
        self.scales[0] = v

    @property
    def y_scale(self):
        return self.scales[1]

    @y_scale.setter
    def y_scale(self, v):
        self.scales[1] = v

    @property
    def z_scale(self):
        return self.scales[2]

    @z_scale.setter
    def z_scale(self, v):
        self.scales[2] = v

    @property
    def x_offset(self):
        return self.offsets[0]

    @x_offset.setter
    def x_offset(self, v):
        self.offsets[0] = v

    @property
    def y_offset(self):
        return self.offsets[1]

    @y_offset.setter
    def y_offset(self, v):
        self.offsets[1] = v

    @property
    def z_offset(self):
        return self.offsets[2]

    @z_offset.setter
    def z_offset(self, v):
        self.offsets[2] = v


@dataclass
class ExtraDim:
    name: str
    dtype: np.dtype
    description: str = ""


class LasData:
    """Decoded LAS point records with scaled coordinate accessors."""

    def __init__(self, header: LasHeader, records: np.ndarray, extra_dims: Sequence[ExtraDim]):
        self.header = header
        self._records = records
        self.extra_dims = list(extra_dims)
        self._fmt = header.point_format

    # -- dimension access ------------------------------------------------------

    @property
    def dimension_names(self) -> List[str]:
        std = ["X", "Y", "Z"] + [
            n for n, _ in _FMT_FIELDS[self._fmt][3:] if not n.endswith("_byte") and n != "raw_classification"
        ]
        bits = [n for n, _, _, _ in _bitfield_dims(self._fmt)]
        extras = [d.name for d in self.extra_dims]
        # order: X Y Z intensity <bitfields> <remaining standard> <extras>
        rest = [n for n in std[3:] if n != "intensity"]
        return ["X", "Y", "Z", "intensity"] + bits + rest + extras

    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, name: str) -> np.ndarray:
        rec = self._records
        if name in ("X", "Y", "Z"):
            return rec[name]
        if name in ("x", "y", "z"):
            i = "xyz".index(name)
            return rec[name.upper()] * self.header.scales[i] + self.header.offsets[i]
        if name in rec.dtype.names:
            return rec[name]
        for bname, src, shift, width in _bitfield_dims(self._fmt):
            if bname == name:
                return (rec[src] >> shift) & ((1 << width) - 1)
        raise KeyError(name)

    @property
    def x(self) -> np.ndarray:
        return self["x"]

    @property
    def y(self) -> np.ndarray:
        return self["y"]

    @property
    def z(self) -> np.ndarray:
        return self["z"]

    @property
    def xyz(self) -> np.ndarray:
        return np.stack([self.x, self.y, self.z], axis=1)


# ---- reading -------------------------------------------------------------------


def _parse_extra_bytes_vlr(payload: bytes) -> List[ExtraDim]:
    dims = []
    for off in range(0, len(payload) - 191, 192):
        rec = payload[off : off + 192]
        data_type = rec[2]
        name = rec[4:36].split(b"\0")[0].decode("ascii", "replace")
        desc = rec[160:192].split(b"\0")[0].decode("ascii", "replace")
        if data_type in _EB_TYPES:
            dims.append(ExtraDim(name, np.dtype(_EB_TYPES[data_type]), desc))
        elif data_type == 0:
            # LAS 1.4 Extra Bytes: data_type 0 = "undocumented bytes", whose
            # SIZE is the options field (byte 3) — assuming 1 byte would shift
            # every subsequent extra dim's offset and silently corrupt values
            size = max(int(rec[3]), 1)
            dims.append(ExtraDim(name, np.dtype(("V", size)), desc))
        elif 11 <= data_type <= 30:
            # deprecated composite types: 11-20 are 2-element, 21-30 are
            # 3-element arrays of base types 1-10 — size them correctly so
            # later extra dims stay aligned (values exposed as raw bytes)
            mult = 2 if data_type <= 20 else 3
            base = data_type - 10 if data_type <= 20 else data_type - 20
            size = mult * np.dtype(_EB_TYPES[base]).itemsize
            dims.append(ExtraDim(name, np.dtype(("V", size)), desc))
        else:  # reserved/unknown: 1 raw byte placeholder
            dims.append(ExtraDim(name, np.dtype(("V", 1)), desc))
    return dims


class _LaspyLaz:
    """Duck-typed ``LasData`` over a laspy file — the LAZ-compressed path.

    LASzip decompression (arithmetic-coded point streams) is delegated to the
    optional ``laspy[lazrs]`` dependency rather than reimplemented: a
    from-scratch decoder could only be roundtrip-verified in this environment
    (no laszip/pdal/laspy to generate compliance fixtures against), and a
    subtly-wrong LAZ codec silently corrupts user data. Mirrors the reference's
    own surface, which reads whatever laspy supports
    (``pointcloud_dataloader.py:22``). Exposes the accessors ``read_las`` uses:
    ``xyz``, ``dimension_names``, ``__getitem__``.
    """

    def __init__(self, f):
        self._f = f

    def __len__(self):
        return len(self._f.points)

    @property
    def xyz(self) -> np.ndarray:
        f = self._f
        return np.stack(
            [np.asarray(f.x, np.float64), np.asarray(f.y, np.float64),
             np.asarray(f.z, np.float64)], axis=1
        )

    @property
    def dimension_names(self) -> List[str]:
        return list(self._f.point_format.dimension_names)

    def __getitem__(self, name: str) -> np.ndarray:
        if name in ("x", "y", "z"):
            return np.asarray(getattr(self._f, name), np.float64)
        return np.asarray(self._f[name])


def _read_laz(path: str) -> "_LaspyLaz":
    try:
        import laspy  # optional dependency — NOT in the base environment
    except ImportError as e:
        raise ValueError(
            f"{path}: LAZ-compressed input requires the optional 'laspy[lazrs]' "
            "dependency (not installed in this environment). Either install it "
            "or decompress offline (laszip / las2las) to plain .las first."
        ) from e
    try:
        return _LaspyLaz(laspy.read(path))
    except Exception as e:  # pragma: no cover - depends on optional backend
        raise ValueError(f"{path}: LAZ decode failed: {e}") from e


def read(path: str) -> LasData:
    """Read a LAS 1.1-1.4 file (uncompressed; LAZ via optional laspy)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS file (bad signature {raw[:4]!r})")

    ver_major, ver_minor = raw[24], raw[25]
    header_size = struct.unpack_from("<H", raw, 94)[0]
    point_offset = struct.unpack_from("<L", raw, 96)[0]
    n_vlrs = struct.unpack_from("<L", raw, 100)[0]
    fmt_byte = raw[104]
    point_format = fmt_byte & 0x3F  # high bits flag LAZ compression
    if fmt_byte & 0xC0:
        return _read_laz(path)
    record_len = struct.unpack_from("<H", raw, 105)[0]
    legacy_count = struct.unpack_from("<L", raw, 107)[0]
    scales = np.asarray(struct.unpack_from("<3d", raw, 131))
    offsets = np.asarray(struct.unpack_from("<3d", raw, 155))
    bounds = struct.unpack_from("<6d", raw, 179)
    count = legacy_count
    if (ver_major, ver_minor) >= (1, 4) and header_size >= 375:
        count64 = struct.unpack_from("<Q", raw, 247)[0]
        if count64:
            count = count64

    if point_format not in _FMT_FIELDS:
        raise ValueError(f"{path}: unsupported point format {point_format}")

    # walk VLRs for extra-bytes descriptors
    extra_dims: List[ExtraDim] = []
    pos = header_size
    for _ in range(n_vlrs):
        user_id = raw[pos + 2 : pos + 18].split(b"\0")[0]
        record_id = struct.unpack_from("<H", raw, pos + 18)[0]
        rec_len = struct.unpack_from("<H", raw, pos + 20)[0]
        payload = raw[pos + 54 : pos + 54 + rec_len]
        if user_id == b"LASF_Spec" and record_id == 4:
            extra_dims = _parse_extra_bytes_vlr(payload)
        pos += 54 + rec_len

    base_fields = list(_FMT_FIELDS[point_format])
    base_size = _STD_SIZES[point_format]
    extra_size = record_len - base_size
    dt_fields = base_fields + [(d.name, d.dtype.str) for d in extra_dims]
    known_extra = sum(d.dtype.itemsize for d in extra_dims)
    if extra_size > known_extra:  # undescribed trailing bytes
        dt_fields.append(("_undescribed", f"V{extra_size - known_extra}"))
    elif extra_size < known_extra:
        raise ValueError(
            f"{path}: record length {record_len} smaller than descriptors imply"
        )
    dtype = np.dtype(dt_fields)
    assert dtype.itemsize == record_len, (dtype.itemsize, record_len)

    records = np.frombuffer(raw, dtype=dtype, count=count, offset=point_offset)
    header = LasHeader(
        version=(ver_major, ver_minor),
        point_format=point_format,
        scales=scales,
        offsets=offsets,
        point_count=count,
        mins=np.asarray([bounds[1], bounds[3], bounds[5]]),
        maxs=np.asarray([bounds[0], bounds[2], bounds[4]]),
    )
    return LasData(header, records, extra_dims)


# ---- writing -------------------------------------------------------------------


def _extra_bytes_vlr(extra_dims: Sequence[ExtraDim]) -> bytes:
    out = b""
    for d in extra_dims:
        code = _EB_CODE_FOR.get(np.dtype(d.dtype.str.lstrip("<|")), None)
        if code is None:
            raise ValueError(f"extra dim {d.name}: unsupported dtype {d.dtype}")
        rec = bytearray(192)
        rec[2] = code
        rec[4:4 + min(32, len(d.name))] = d.name.encode("ascii")[:32]
        desc = d.description.encode("ascii")[:32]
        rec[160:160 + len(desc)] = desc
        out += bytes(rec)
    return out


def write(
    path: str,
    coords: np.ndarray,
    header: Optional[LasHeader] = None,
    attributes: Optional[Dict[str, np.ndarray]] = None,
    intensity: Optional[np.ndarray] = None,
) -> None:
    """Write a LAS file (1.2 or 1.4). Unknown attribute names become Extra Bytes
    dimensions (matching laspy's add_extra_dim fallback used by the reference's
    ``write_las`` — ``downsampling_point_clouds.py:118-123``)."""
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    hdr = header or LasHeader()
    fmt = hdr.point_format
    if fmt not in _FMT_FIELDS:
        raise ValueError(f"unsupported point format {fmt}")
    attributes = dict(attributes or {})
    if intensity is not None:
        attributes["intensity"] = intensity

    base_fields = list(_FMT_FIELDS[fmt])
    std_names = {f[0] for f in base_fields}
    extra_dims = [
        ExtraDim(k, np.asarray(v).dtype) for k, v in attributes.items() if k not in std_names
    ]
    dtype = np.dtype(base_fields + [(d.name, d.dtype.str) for d in extra_dims])
    rec = np.zeros(n, dtype)

    ixyz = np.round((coords - hdr.offsets) / hdr.scales).astype(np.int64)
    if np.abs(ixyz).max(initial=0) > 2**31 - 1:
        raise ValueError("coordinates overflow int32 at this scale/offset; adjust header")
    rec["X"], rec["Y"], rec["Z"] = ixyz[:, 0].astype(np.int32), ixyz[:, 1].astype(np.int32), ixyz[:, 2].astype(np.int32)
    rec["ret_byte"] = 0x11 if fmt >= 6 else 0x09  # 1 return of 1
    for k, v in attributes.items():
        if k in std_names:
            rec[k] = v
        else:
            rec[k] = np.asarray(v)

    ver = (1, 4) if fmt >= 6 else hdr.version
    header_size = 375 if ver >= (1, 4) else 227
    vlr_payload = _extra_bytes_vlr(extra_dims) if extra_dims else b""
    vlrs = b""
    if vlr_payload:
        vlr_hdr = struct.pack("<H16sHH32s", 0, b"LASF_Spec", 4, len(vlr_payload), b"extra bytes")
        vlrs = vlr_hdr + vlr_payload
    point_offset = header_size + len(vlrs)

    mins, maxs = coords.min(axis=0), coords.max(axis=0)
    buf = bytearray(header_size)
    buf[0:4] = b"LASF"
    buf[24], buf[25] = ver
    buf[26:26 + 21] = b"dl_biomass_tpu las\0\0\0"[:21]
    struct.pack_into("<H", buf, 94, header_size)
    struct.pack_into("<L", buf, 96, point_offset)
    struct.pack_into("<L", buf, 100, 1 if vlrs else 0)
    buf[104] = fmt
    struct.pack_into("<H", buf, 105, dtype.itemsize)
    struct.pack_into("<L", buf, 107, n if (ver < (1, 4) and n < 2**32) else 0)
    struct.pack_into("<3d", buf, 131, *hdr.scales)
    struct.pack_into("<3d", buf, 155, *hdr.offsets)
    struct.pack_into("<6d", buf, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2])
    if ver >= (1, 4):
        struct.pack_into("<Q", buf, 247, n)
        struct.pack_into("<Q", buf, 255, n)  # points by return[0]

    with open(path, "wb") as f:
        f.write(bytes(buf))
        f.write(vlrs)
        f.write(rec.tobytes())
