"""Training observability: a JSONL log, TensorBoard event files, histograms.

Counterpart of clsr_tpu/utils/summaries.py:18-101, which replaces the
reference's tf.summary scalar and histogram stream (clsr.py:111-276,
448-455, sequential_base_model.py:140-146):

  * `<log_dir>/scalars.jsonl`, one record a call: {"step", "time",
    name: value, ...}, and one a histogram: {"step", "hist", "lo", "hi",
    "counts"[, "nonfinite"]};
  * with `write_tfevents`, TensorBoard event files in `log_dir`.  JAX
    writes them through TensorFlow when it imports; the port imports
    neither TensorFlow nor tensorboard and writes the files itself
    (`EventFileWriter`), so it writes them whenever asked: TFRecord
    framing (length, masked CRC32C of the length, the record, masked
    CRC32C of the record) around `Event` protobufs encoded by hand, as
    TensorFlow 2's writer lays them out: a first event with the file
    version, then each scalar as a 0-d float tensor under the scalars
    plugin and each histogram as the histogram plugin's [k, 3] float64
    tensor (left edge, right edge, count).  `read_events` reads such a
    file back (CRCs checked), for the checks of chip_smoke.py.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ------------------------------------------------------------ CRC32C


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum TFRecord frames carry."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------- protobuf encoding

_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5
DT_FLOAT, DT_DOUBLE = 1, 2          # tensorflow.DataType


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1              # negative int64s as two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == _VARINT:
        return key + _varint(payload)
    if wire == _BYTES:
        return key + _varint(len(payload)) + payload
    return key + payload            # fixed32 / fixed64, packed already


def _tensor(array: np.ndarray, dtype: int) -> bytes:
    """TensorProto: dtype, shape, little-endian tensor_content."""
    shape = b"".join(_field(2, _BYTES, _field(1, _VARINT, d))
                     for d in array.shape)
    np_type = "<f4" if dtype == DT_FLOAT else "<f8"
    return (_field(1, _VARINT, dtype) + _field(2, _BYTES, shape)
            + _field(4, _BYTES, np.ascontiguousarray(
                array, dtype=np_type).tobytes()))


def _metadata(plugin: str, display_name: str = "") -> bytes:
    """SummaryMetadata: plugin_data {plugin_name}, display_name."""
    out = _field(1, _BYTES, _field(1, _BYTES, plugin.encode()))
    if display_name:
        out += _field(2, _BYTES, display_name.encode())
    return out


def _event(step: int, body: bytes, wall_time: Optional[float] = None
           ) -> bytes:
    """Event: wall_time, step (omitted at 0, as proto3 does), then the
    body's fields."""
    out = _field(1, _FIXED64, struct.pack(
        "<d", time.time() if wall_time is None else wall_time))
    if step:
        out += _field(2, _VARINT, step)
    return out + body


def _summary_value(tag: str, tensor: bytes, metadata: bytes) -> bytes:
    """Event.summary (field 5) with one Summary.Value: tag (1), tensor
    (8), metadata (9)."""
    value = (_field(1, _BYTES, tag.encode()) + _field(8, _BYTES, tensor)
             + _field(9, _BYTES, metadata))
    return _field(5, _BYTES, _field(1, _BYTES, value))


def frame(record: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the record, its masked CRC."""
    length = struct.pack("<Q", len(record))
    return (length + struct.pack("<I", masked_crc32c(length)) + record
            + struct.pack("<I", masked_crc32c(record)))


class EventFileWriter:
    """A TensorBoard event file in `log_dir`, named as TensorFlow names
    them (`events.out.tfevents.<time>.<host>.<pid>.<uid>.v2`)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}."
                     f"{socket.gethostname()}.{os.getpid()}."
                     f"{uuid.uuid4().int % 10 ** 6}.v2")
        self._f = open(self.path, "wb")
        source = _field(1, _BYTES, b"clsr_tpu_torch.utils.summaries")
        self._write(_event(0, _field(3, _BYTES, b"brain.Event:2")
                           + _field(10, _BYTES, source), wall_time=now))
        self.flush()

    def _write(self, record: bytes) -> None:
        self._f.write(frame(record))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(step, _summary_value(
            tag, _tensor(np.float32(value), DT_FLOAT),
            _metadata("scalars"))))

    def histogram(self, tag: str, buckets: np.ndarray, step: int) -> None:
        """`buckets` [k, 3] (left edge, right edge, count), float64."""
        self._write(_event(step, _summary_value(
            tag, _tensor(np.asarray(buckets, np.float64), DT_DOUBLE),
            _metadata("histograms", display_name=tag))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------ reading


def _parse(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: ints for
    varints, bytes for the rest."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, i = _read_varint(buf, i)
        elif wire == _FIXED64:
            value, i = buf[i:i + 8], i + 8
        elif wire == _FIXED32:
            value, i = buf[i:i + 4], i + 4
        elif wire == _BYTES:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield num, wire, value


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7


def _read_tensor(buf: bytes) -> np.ndarray:
    dtype, shape, content = None, [], b""
    for num, _, value in _parse(buf):
        if num == 1:
            dtype = value
        elif num == 2:
            for dnum, _, dim in _parse(value):
                if dnum == 2:
                    shape.append(dict((n, v) for n, _, v in
                                      _parse(dim)).get(1, 0))
        elif num == 4:
            content = value
    np_type = {DT_FLOAT: "<f4", DT_DOUBLE: "<f8"}[dtype]
    return np.frombuffer(content, np_type).reshape(shape)


def read_events(path: str) -> List[dict]:
    """The events of a file that `EventFileWriter` (or TensorFlow 2's
    writer, for these summaries) wrote: [{"wall_time", "step",
    "file_version"} or {"wall_time", "step", "values": [{"tag",
    "plugin", "display_name", "tensor"}]}]; raises on a bad CRC."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        length = data[i:i + 8]
        (n,) = struct.unpack("<Q", length)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        record = data[i + 12:i + 12 + n]
        (rcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc32c(length) or rcrc != masked_crc32c(record):
            raise ValueError(f"{path}: bad CRC in the record at byte {i}")
        i += 16 + n
        event = {"step": 0}
        for num, _, value in _parse(record):
            if num == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif num == 2:
                event["step"] = value
            elif num == 3:
                event["file_version"] = value.decode()
            elif num == 5:
                event["values"] = [_read_value(v) for vn, _, v in
                                   _parse(value) if vn == 1]
        events.append(event)
    return events


def _read_value(buf: bytes) -> dict:
    out = {"plugin": "", "display_name": ""}
    for num, _, value in _parse(buf):
        if num == 1:
            out["tag"] = value.decode()
        elif num == 8:
            out["tensor"] = _read_tensor(value)
        elif num == 9:
            for mnum, _, m in _parse(value):
                if mnum == 1:
                    out["plugin"] = dict(
                        (n, v) for n, _, v in _parse(m)).get(1, b"").decode()
                elif mnum == 2:
                    out["display_name"] = m.decode()
    return out


# ------------------------------------------------------------ the writer


class SummaryWriter:
    def __init__(self, log_dir: Optional[str], write_tfevents: bool = False):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb: Optional[EventFileWriter] = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            if write_tfevents:
                self._tb = EventFileWriter(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if self._jsonl is not None:
            rec = {"step": step, "time": time.time()}
            rec.update({k: float(v) for k, v in values.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.scalar(k, float(v), step)
            self._tb.flush()

    def histograms(self, step: int, hists) -> None:
        """Write activation histograms computed on the device.

        `hists`: {tag: (counts [k], lo, hi[, n_nonfinite])}, as
        training/steps.py `make_histogram_step` gives them (numpy).
        JSONL always; with tfevents the histogram plugin's [k, 3]
        (left edge, right edge, count) tensor, the edges spaced evenly
        over [lo, hi].  lo and hi are clamped to finite values so that
        the JSONL stays strict JSON."""
        if self._jsonl is None and self._tb is None:
            return

        def fin(v):
            return float(np.nan_to_num(float(v), posinf=0.0, neginf=0.0))

        items = {tag: (np.asarray(t[0]), fin(t[1]), fin(t[2]),
                       int(t[3]) if len(t) > 3 else 0)
                 for tag, t in hists.items()}
        if self._jsonl is not None:
            for tag, (counts, lo, hi, bad) in sorted(items.items()):
                rec = {"step": step, "hist": tag, "lo": lo, "hi": hi,
                       "counts": counts.tolist()}
                if bad:
                    rec["nonfinite"] = bad
                self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for tag, (counts, lo, hi, _bad) in sorted(items.items()):
                edges = np.linspace(lo, hi, counts.shape[0] + 1)
                self._tb.histogram(tag, np.stack(
                    [edges[:-1], edges[1:], counts.astype(np.float64)],
                    axis=1), step)
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
