"""Per-frame side data: HDR/DoVi metadata passthrough.

The PyTorch port's own copy of hopperrender_tpu/server/sidedata.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour.

The reference attaches 8 binary side-data blobs to every media sample and copies all
of them from the input sample to every interpolated output sample
(ref: HopperRender.cpp:876-901 read, :993-1022 write; GUID contract IMediaSideData.h).

Here side data is an opaque {key: bytes} mapping carried alongside each frame; the
canonical keys below mirror the reference's GUID set one-for-one. Typed views are
provided for the two metadata blocks a TPU serving stack actually needs to interpret
(mastering display + content light level); the rest pass through untouched.
"""

from __future__ import annotations

import dataclasses
import struct

# Canonical keys, one per reference GUID (ref: IMediaSideData.h):
KEY_HDR = "hdr"                          # MediaSideDataHDR (:39-49)
KEY_CONTENT_LIGHT_LEVEL = "hdr_cll"      # MediaSideDataHDRContentLightLevel (:57-63)
KEY_HDR10PLUS = "hdr10plus"              # MediaSideDataHDR10Plus (:76-128)
KEY_DOVI_METADATA = "dovi_metadata"      # MediaSideDataDOVIMetadata (:142-227)
KEY_DOVI_RPU = "dovi_rpu"                # raw RPU buffer
KEY_CONTROL_FLAGS = "control_flags"      # MediaSideDataControlFlags (:266-273)
KEY_EIA608 = "eia608"                    # EIA-608 closed captions (:255-260)
KEY_3D_OFFSET = "offset_3d"              # MediaSideData3DOffset (:239-248)

ALL_KEYS = (
    KEY_DOVI_METADATA, KEY_DOVI_RPU, KEY_CONTROL_FLAGS, KEY_HDR, KEY_HDR10PLUS,
    KEY_CONTENT_LIGHT_LEVEL, KEY_EIA608, KEY_3D_OFFSET,
)


def passthrough(side_data: dict[str, bytes] | None) -> dict[str, bytes]:
    """Copy every non-empty blob to an output frame (ref: HopperRender.cpp:993-1022
    copies each blob whose size > 0)."""
    if not side_data:
        return {}
    return {k: v for k, v in side_data.items() if v}


@dataclasses.dataclass
class MasteringDisplayMetadata:
    """Typed view of MediaSideDataHDR (ref: IMediaSideData.h:39-49): SMPTE ST 2086
    mastering display primaries/white point/luminance, stored as doubles."""

    primaries_x: tuple[float, float, float]
    primaries_y: tuple[float, float, float]
    white_point: tuple[float, float]
    max_luminance: float
    min_luminance: float

    _FMT = "<10d"

    def to_bytes(self) -> bytes:
        return struct.pack(
            self._FMT, *self.primaries_x, *self.primaries_y, *self.white_point,
            self.max_luminance, self.min_luminance,
        )

    @classmethod
    def from_bytes(cls, blob: bytes) -> "MasteringDisplayMetadata":
        v = struct.unpack(cls._FMT, blob[: struct.calcsize(cls._FMT)])
        return cls(
            primaries_x=(v[0], v[1], v[2]), primaries_y=(v[3], v[4], v[5]),
            white_point=(v[6], v[7]), max_luminance=v[8], min_luminance=v[9],
        )


@dataclasses.dataclass
class ContentLightLevel:
    """Typed view of MediaSideDataHDRContentLightLevel (ref: IMediaSideData.h:57-63):
    MaxCLL / MaxFALL in nits (unsigned ints)."""

    max_cll: int
    max_fall: int

    _FMT = "<II"

    def to_bytes(self) -> bytes:
        return struct.pack(self._FMT, self.max_cll, self.max_fall)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "ContentLightLevel":
        max_cll, max_fall = struct.unpack(cls._FMT, blob[: struct.calcsize(cls._FMT)])
        return cls(max_cll=max_cll, max_fall=max_fall)
