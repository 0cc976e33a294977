"""Volume I/O: byte-range loaders and format readers (RAW / ZIP / BVP).

The port's copy of vpt_tpu/scene/io.py (numpy only).

Mirrors the reference's two-level loader/reader split so any byte source can
feed any format:
  - loaders: readLength/readData byte-range abstraction
    (the reference's src/js/loaders/AbstractLoader.js:1-11, AjaxLoader Range
    reads, BlobLoader slicing)
  - readers: readMetadata/readBlock
    (the reference's src/js/readers/{RAWReader,ZIPReader,BVPReader}.js)

A native C++ fast path (native/vptio) is used for large ZIP/RAW scans when the
compiled library is present; these pure-Python implementations are the
reference behavior and the fallback.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


# --------------------------------------------------------------------------
# Loaders: byte sources
# --------------------------------------------------------------------------
class AbstractLoader:
    def read_length(self) -> int:
        raise NotImplementedError

    def read_data(self, start: int, end: int) -> bytes:
        raise NotImplementedError


class FileLoader(AbstractLoader):
    """Random-access file loader (the BlobLoader analog)."""

    def __init__(self, path: str):
        self.path = path

    def read_length(self) -> int:
        return os.path.getsize(self.path)

    def read_data(self, start: int, end: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(start)
            return f.read(end - start)


class BytesLoader(AbstractLoader):
    """In-memory byte source."""

    def __init__(self, data: bytes):
        self.data = data

    def read_length(self) -> int:
        return len(self.data)

    def read_data(self, start: int, end: int) -> bytes:
        return self.data[start:end]


class HTTPLoader(AbstractLoader):
    """HTTP byte-range loader (the AjaxLoader analog).

    Parity: the reference's src/js/loaders/AjaxLoader.js:20-26 — a HEAD
    request for Content-Length, then partial reads via the Range header
    (`bytes=start-end`, end inclusive like the reference's `end - 1`).
    The reference ships bin/server-node with Range support for exactly
    this; any Range-capable static server works (tests use a stdlib
    http.server fixture with a Range handler).
    """

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url
        self.timeout = timeout

    def read_length(self) -> int:
        import urllib.request

        req = urllib.request.Request(self.url, method="HEAD")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            length = resp.headers.get("Content-Length")
            if length is None:
                raise IOError(f"no Content-Length from {self.url}")
            return int(length)

    def read_data(self, start: int, end: int) -> bytes:
        import urllib.request

        if end <= start:
            return b""
        req = urllib.request.Request(
            self.url, headers={"Range": f"bytes={start}-{end - 1}"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = resp.read()
        if resp.status == 200 and len(data) > end - start:
            # server ignored Range and sent the whole entity — slice locally
            return data[start:end]
        if len(data) != end - start:
            raise IOError(
                f"range read [{start},{end}) returned {len(data)} bytes"
            )
        return data


# --------------------------------------------------------------------------
# Readers: formats
# --------------------------------------------------------------------------
class RAWReader:
    """Headerless W×H×D uint8 volume; blocks are z-slices.

    Parity: RAWReader.js:14-69 (synthesized per-slice placements).
    """

    def __init__(self, loader: AbstractLoader, width: int, height: int, depth: int):
        self.loader = loader
        self.width, self.height, self.depth = width, height, depth

    def read_metadata(self) -> dict:
        placements = [
            {"index": i, "position": {"x": 0, "y": 0, "z": i}}
            for i in range(self.depth)
        ]
        blocks = [
            {
                "url": "default",
                "format": "raw",
                "dimensions": {"width": self.width, "height": self.height, "depth": 1},
            }
            for _ in range(self.depth)
        ]
        return {
            "meta": {"version": 1},
            "modalities": [
                {
                    "name": "default",
                    "dimensions": {
                        "width": self.width,
                        "height": self.height,
                        "depth": self.depth,
                    },
                    "format": 6403,
                    "internalFormat": 33321,
                    "type": 5121,
                    "placements": placements,
                }
            ],
            "blocks": blocks,
        }

    def read_block(self, i: int) -> bytes:
        slice_bytes = self.width * self.height
        return self.loader.read_data(i * slice_bytes, (i + 1) * slice_bytes)


class ZIPReader:
    """Minimal ZIP reader: EOCD scan + central directory; stored entries only.

    Parity: ZIPReader.js:20-91 (same minimal EOCD/CD parse, byte-range reads).
    """

    _EOCD_MIN = 22

    def __init__(self, loader: AbstractLoader):
        self.loader = loader
        self._cd: Optional[List[dict]] = None

    def _read_eocd(self) -> dict:
        length = self.loader.read_length()
        offset = max(length - self._EOCD_MIN, 0)
        data = self.loader.read_data(offset, offset + min(length, self._EOCD_MIN))
        entries, size, cd_offset = struct.unpack_from("<HII", data, 10)
        return {"entries": entries, "size": size, "offset": cd_offset}

    def _read_cd(self) -> List[dict]:
        if self._cd is not None:
            return self._cd
        eocd = self._read_eocd()
        data = self.loader.read_data(eocd["offset"], eocd["offset"] + eocd["size"])
        entries = []
        off = 0
        for _ in range(eocd["entries"]):
            (
                gpflag,
                method,
            ) = struct.unpack_from("<HH", data, off + 8)
            compressed, uncompressed = struct.unpack_from("<II", data, off + 20)
            name_len, extra_len, comment_len = struct.unpack_from("<HHH", data, off + 28)
            header_offset = struct.unpack_from("<I", data, off + 42)[0]
            name = data[off + 46 : off + 46 + name_len].decode("utf-8")
            entries.append(
                {
                    "gpflag": gpflag,
                    "method": method,
                    "compressed_size": compressed,
                    "uncompressed_size": uncompressed,
                    "name": name,
                    "header_offset": header_offset,
                }
            )
            off += 46 + name_len + extra_len + comment_len
        self._cd = entries
        return entries

    def get_files(self) -> List[str]:
        return [e["name"] for e in self._read_cd()]

    def read_file(self, name: str) -> bytes:
        entry = next((e for e in self._read_cd() if e["name"] == name), None)
        if entry is None:
            raise FileNotFoundError(f"ZIPReader: file {name} not in CD")
        header = self.loader.read_data(entry["header_offset"], entry["header_offset"] + 30)
        name_len, extra_len = struct.unpack_from("<HH", header, 26)
        data_start = entry["header_offset"] + 30 + name_len + extra_len
        return self.loader.read_data(data_start, data_start + entry["compressed_size"])


class BVPReader:
    """BVP = ZIP archive containing manifest.json + block files.

    Parity: BVPReader.js:12-29.
    """

    def __init__(self, loader: AbstractLoader):
        self.zip = ZIPReader(loader)
        self._metadata: Optional[dict] = None

    def read_metadata(self) -> dict:
        if self._metadata is None:
            self._metadata = json.loads(self.zip.read_file("manifest.json").decode("utf-8"))
        return self._metadata

    def read_block(self, i: int) -> bytes:
        meta = self.read_metadata()
        return self.zip.read_file(meta["blocks"][i]["url"])


READERS = {"raw": RAWReader, "zip": ZIPReader, "bvp": BVPReader}


def make_reader(kind: str, loader: AbstractLoader, **kw):
    """Factory dispatch by string key (ReaderFactory.js:20-28)."""
    try:
        return READERS[kind](loader, **kw)
    except KeyError:
        raise ValueError(f"unknown reader kind {kind!r}; known: {sorted(READERS)}")


# --------------------------------------------------------------------------
# ZIP writing (for round-tripping BVP fixtures; stored entries only)
# --------------------------------------------------------------------------
def write_stored_zip(path: str, files: Dict[str, bytes]):
    """Write a stored-only (no compression) ZIP with the given name->bytes."""
    import zipfile

    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        for name, data in files.items():
            z.writestr(name, data)
