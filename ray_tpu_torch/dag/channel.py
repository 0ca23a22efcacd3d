"""Shared-memory channels for compiled actor DAGs.

Reference: `python/ray/experimental/channel/shared_memory_channel.py:176`
backed by the native mutable-object manager
(`experimental_mutable_object_manager.h:48`, `WriteAcquire:153`) —
writer/reader acquire-release over fixed shm slots.

The fast path is the C++ mutable channel in `shm/shmstore.cc`
(`rts_chan_*`): a fixed ring of slots with a process-shared
mutex/condvar, ZERO allocation per message — write serializes straight
into the slot, publication is a sequence bump + broadcast, and the
reader's release hands the slot back (the same acquire/release protocol
as the reference's native channels).  Payloads larger than a slot fall
back to one store object per message; the slot then carries only the
object id.

Tensor payloads (`KIND_TENSOR`) skip pickle entirely: a compact
struct-packed header (dtype/shape/sharding per tensor, container kind,
optional small metadata blob) is followed by the raw array buffers,
written straight into the slot as one publication — multi-output steps
therefore batch into a single slot write.  The reader adopts the bytes
back into `torch.Tensor`s / numpy views without a pickle round trip.

The codec is the JAX package's, byte for byte: the same `<BBBBHI`
head, `<BBBBHHQ` entries and 64-byte alignment, so each package reads
the other's payloads.  An entry's framework byte (the reference's
`is_jax`) marks a torch tensor here, and the byte the reference leaves
0 carries the tensor's device kind (`DEVICE_CPU` / `DEVICE_CUDA`): a
CUDA tensor is copied to the host once, and its reader puts it back on
its own current CUDA device, or raises if it has none.  bf16 crosses as
its raw 16-bit words under the dtype name "bfloat16" (no `ml_dtypes`
needed on either side for torch tensors).  A DTensor (one rank's shard
of a global tensor) and dtypes with no raw form (fp8, quantized) take
the pickle path, as the reference sends a non-fully-addressable array.
The sharding field stays empty.  `HANDLE_DEVICE` is reserved for a
device-to-device channel; this shm path is the host route.

Cross-node channels (reference:
`experimental_mutable_object_provider.h` — remote mutable objects):
the ring always lives on the READER's node; a writer on another node
relays writes through the daemons (`chan_remote_write`), which land in
the reader's local ring — the reader's hot path is identical either
way, and ring-full backpressure propagates to the remote writer through
the blocking daemon call.

Ring geometry comes from the config (`dag_ring_slots` /
`RTT_DAG_RING_SLOTS`, `dag_slot_bytes` / `RTT_DAG_SLOT_BYTES`), validated
at channel creation; per-channel overrides cover special shapes (the
1F1B pipeline's double-buffered activation rings).
"""

from __future__ import annotations

import hashlib
import logging
import struct
import sys
import time
from typing import Any, List, Optional, Tuple

import ray_tpu_torch.shm as _shm
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.metrics import metric_defs as _mdefs
from ray_tpu_torch.shm import ChannelClosedError

logger = logging.getLogger(__name__)

# payload kinds (the ChanSlot.kind field)
KIND_DATA = 0
KIND_ERROR = 1
KIND_SENTINEL = 2  # teardown marker, forwarded downstream
KIND_SPILL_DATA = 3  # oversized: payload lives in a store object
KIND_SPILL_ERROR = 4
KIND_TENSOR = 5  # header + raw array buffers, no pickle
KIND_SPILL_TENSOR = 6  # tensor payload spilled to a store object

# slot kind -> its spilled twin (and back); the daemon relay uses the
# same mapping when an oversized remote write lands on the reader node
SPILL_KIND = {
    KIND_DATA: KIND_SPILL_DATA,
    KIND_ERROR: KIND_SPILL_ERROR,
    KIND_TENSOR: KIND_SPILL_TENSOR,
}
INLINE_KIND = {v: k for k, v in SPILL_KIND.items()}

# tensor-header handle kinds: where the buffer bytes live.  DEVICE is
# reserved for a device-to-device channel; this shm path is the host
# route.
HANDLE_INLINE = 0  # raw bytes follow the header in the same slot
HANDLE_STORE = 1  # raw bytes live in one store object (spill)
HANDLE_DEVICE = 2  # reserved: device buffer handle

# an entry's device kind (the entry's spare byte; the JAX package
# writes 0): where a torch tensor lived, and so where its reader puts it
DEVICE_CPU = 0
DEVICE_CUDA = 1

# torch dtypes with a raw form, by the name the header carries (numpy's
# name for each; bf16 crosses as its 16-bit words)
_TORCH_RAW = frozenset((
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
))

_CONT_SINGLE = 0
_CONT_TUPLE = 1
_CONT_LIST = 2
_CONT_DICT = 3

_TENSOR_VERSION = 1
_ALIGN = 64


class ChannelClosed(Exception):
    pass


class ChannelPollTimeout(Exception):
    """The blocking read expired with NOTHING consumed — distinct from a
    user-raised TimeoutError travelling as an error payload (which is
    consumed before it re-raises)."""


def ring_geometry(ring_slots: Optional[int] = None,
                  slot_bytes: Optional[int] = None) -> Tuple[int, int]:
    """Resolve and VALIDATE channel geometry: explicit overrides win,
    else the config knobs (`RTT_DAG_RING_SLOTS` / `RTT_DAG_SLOT_BYTES`).
    Raises ValueError at channel creation rather than letting a bad
    knob surface as a cryptic native-ring failure mid-execution."""
    cfg = get_config()
    slots = int(cfg.dag_ring_slots if ring_slots is None else ring_slots)
    size = int(cfg.dag_slot_bytes if slot_bytes is None else slot_bytes)
    if not 2 <= slots <= 4096:
        raise ValueError(
            f"dag_ring_slots (RTT_DAG_RING_SLOTS) must be in [2, 4096], "
            f"got {slots} — 1 slot cannot double-buffer and huge rings "
            "pin arena forever"
        )
    if not 1024 <= size <= 256 * 1024 * 1024:
        raise ValueError(
            f"dag_slot_bytes (RTT_DAG_SLOT_BYTES) must be in [1 KiB, "
            f"256 MiB], got {size}"
        )
    return slots, size


def _chan_hash(name: str) -> bytes:
    return hashlib.blake2b(name.encode(), digest_size=18).digest()


# -- tensor codec ------------------------------------------------------
_codec_dtype_memo: dict = {}


def _codec_dtype_ok(dt) -> bool:
    """Can this dtype round-trip through the raw-bytes codec?  Plain
    numeric/bool kinds always do; extended dtypes (bfloat16, fp8 — numpy
    kind 'V' but resolvable by name) are probed once and memoized.
    Structured/object/string dtypes fall back to the pickle path."""
    ok = _codec_dtype_memo.get(dt)
    if ok is None:
        if dt.names is not None or dt.kind in "OUSMm":
            ok = False  # structured/object/string/datetime: pickle path
        elif dt.kind in "biufc":
            ok = True
        else:
            try:  # name-resolvable extended dtype?
                ok = _np_dtype(str(dt)) == dt and len(str(dt)) < 256
            except Exception as e:
                logger.debug("dtype %s takes the pickle path: %s", dt, e)
                ok = False
        _codec_dtype_memo[dt] = ok
    return ok


def _torch_name(dt) -> str:
    """A torch dtype's header name ("float32", "bfloat16", ...)."""
    return str(dt).rpartition(".")[2]


def _is_dtensor(x: Any) -> bool:
    # a DTensor exists only once its module is imported
    for name in ("torch.distributed.tensor", "torch.distributed._tensor"):
        mod = sys.modules.get(name)
        if mod is not None and isinstance(x, mod.DTensor):
            return True
    return False


def _is_tensor(x: Any) -> bool:
    import numpy as np

    if isinstance(x, np.ndarray):
        return _codec_dtype_ok(x.dtype)
    if "torch" in sys.modules:
        import torch

        if isinstance(x, torch.Tensor):
            # a DTensor is one rank's shard of a global tensor and
            # cannot be materialised to host bytes here — it stays on
            # the pickle path, as do dtypes with no raw form (fp8,
            # quantized)
            return _torch_name(x.dtype) in _TORCH_RAW and not _is_dtensor(x)
    return False


def as_tensor_batch(value: Any):
    """(container, keys, arrays) when `value` is a pure tensor payload
    — a single array, or an EXACT builtin tuple/list/str-keyed dict of
    them — else None (the payload takes the pickle path).  Subclasses
    (NamedTuple, OrderedDict, ...) deliberately stay on pickle: the
    codec reconstructs builtin containers only, and silently degrading
    a typed container would break its consumers."""
    if _is_tensor(value):
        return _CONT_SINGLE, None, [value]
    if type(value) in (tuple, list) and value and all(
        _is_tensor(v) for v in value
    ):
        cont = _CONT_TUPLE if type(value) is tuple else _CONT_LIST
        return cont, None, list(value)
    if (
        type(value) is dict
        and value
        and all(isinstance(k, str) for k in value)
        and all(_is_tensor(v) for v in value.values())
    ):
        return _CONT_DICT, list(value.keys()), list(value.values())
    return None


def _np_dtype(name: str):
    import numpy as np

    try:
        return np.dtype(name)
    except TypeError:
        # extended dtypes (bfloat16, fp8) of numpy arrays written by a
        # JAX writer; ml_dtypes comes with JAX
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))


def _host_view(t: Any) -> Tuple[Any, str, int]:
    """(numpy view of a torch tensor's bytes on the host, its header
    dtype name, its device kind): a CUDA tensor is copied to the host
    once; bf16 is viewed as its 16-bit words."""
    import torch

    dev = DEVICE_CUDA if t.is_cuda else DEVICE_CPU
    t = t.detach().resolve_conj().resolve_neg().contiguous().cpu()
    name = _torch_name(t.dtype)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name, dev


def encode_tensors(value: Any, extra: Any = None,
                   handle_kind: int = HANDLE_INLINE
                   ) -> Tuple[List[Any], int]:
    """Encode a tensor batch to (chunks, total_bytes): a struct-packed
    header chunk followed by 64-byte-aligned raw buffers.  `extra` is a
    small control-plane blob (pickled; e.g. the rllib sample meta) —
    the ARRAY bytes never see pickle.  numpy arrays and torch tensors
    mix freely; a torch entry is marked as one, with its device kind."""
    import numpy as np

    tb = as_tensor_batch(value)
    if tb is None:
        raise TypeError(
            f"not a tensor payload: {type(value)} (need array, "
            "tuple/list of arrays, or str-keyed dict of arrays)"
        )
    container, keys, arrays = tb
    extra_b = ser.dumps_oob(extra) if extra is not None else b""
    head = bytearray()
    head += struct.pack("<BBBBHI", _TENSOR_VERSION, container, handle_kind,
                        0, len(arrays), len(extra_b))
    head += extra_b
    bufs: List[Any] = []
    for i, arr in enumerate(arrays):
        is_torch = not isinstance(arr, np.ndarray)
        if is_torch:
            host, name, dev = _host_view(arr)
        else:
            host, dev = arr, DEVICE_CPU
            if not host.flags["C_CONTIGUOUS"]:
                host = np.ascontiguousarray(host)
            name = str(host.dtype)
        dt = name.encode()
        key = keys[i].encode() if container == _CONT_DICT else b""
        shard = b""  # no sharding metadata: a DTensor takes pickle
        head += struct.pack("<BBBBHHQ", 1 if is_torch else 0, len(dt),
                            host.ndim, dev, len(key), len(shard),
                            host.nbytes)
        head += dt + key + shard
        head += struct.pack(f"<{host.ndim}Q", *host.shape)
        bufs.append(host)
    chunks: List[Any] = [bytes(head)]
    pos = len(head)
    for host in bufs:
        pad = (-pos) % _ALIGN
        if pad:
            chunks.append(b"\x00" * pad)
            pos += pad
        try:
            view = memoryview(host).cast("B")
        except (ValueError, TypeError):
            # extended dtypes (bfloat16, fp8) refuse the buffer
            # protocol; a flat uint8 view exposes the same bytes
            view = memoryview(host.reshape(-1).view(np.uint8))
        chunks.append(view)
        pos += view.nbytes
    return chunks, pos


def parse_tensor_header(buf: memoryview):
    """Walk a KIND_TENSOR payload's header.  Returns (container, extra,
    entries, buffers_start) where each entry is a dict with key/dtype/
    shape/is_torch/device/sharding/nbytes/offset — the offsets index
    into `buf`.  `is_torch` is the framework byte (a JAX writer's
    `jax.Array` reads as a torch tensor here).  Exposed for tests and
    the future device-channel adopt path."""
    buf = memoryview(buf).cast("B")
    ver, container, handle_kind, _, n, extra_len = struct.unpack_from(
        "<BBBBHI", buf, 0
    )
    if ver != _TENSOR_VERSION:
        raise ValueError(f"unknown tensor header version {ver}")
    pos = struct.calcsize("<BBBBHI")
    extra = ser.loads(buf[pos:pos + extra_len]) if extra_len else None
    pos += extra_len
    entries = []
    for _ in range(n):
        is_torch, dt_len, ndim, dev, key_len, shard_len, nbytes = (
            struct.unpack_from("<BBBBHHQ", buf, pos)
        )
        pos += struct.calcsize("<BBBBHHQ")
        dtype = bytes(buf[pos:pos + dt_len]).decode()
        pos += dt_len
        key = bytes(buf[pos:pos + key_len]).decode() if key_len else None
        pos += key_len
        shard = bytes(buf[pos:pos + shard_len]).decode() if shard_len else ""
        pos += shard_len
        shape = struct.unpack_from(f"<{ndim}Q", buf, pos)
        pos += 8 * ndim
        entries.append({
            "key": key, "dtype": dtype, "shape": tuple(shape),
            "is_torch": bool(is_torch), "device": dev, "sharding": shard,
            "nbytes": nbytes,
        })
    head_end = pos
    off = head_end
    for e in entries:
        off += (-off) % _ALIGN
        e["offset"] = off
        off += e["nbytes"]
    return container, extra, entries, head_end


def _adopt_torch(raw: memoryview, e: dict) -> Any:
    """A torch entry's bytes as a tensor, copied (the message bytes are
    read-only and do not outlive the read), on the reader's current
    CUDA device when the writer's tensor was on one."""
    import torch

    dtype = getattr(torch, e["dtype"])
    if e["nbytes"]:
        t = torch.frombuffer(bytearray(raw), dtype=dtype).reshape(e["shape"])
    else:
        t = torch.empty(e["shape"], dtype=dtype)
    if e["device"] == DEVICE_CUDA:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor arrived on a channel whose reader has no "
                "CUDA device"
            )
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def decode_tensors(buf: memoryview) -> Tuple[Any, Any]:
    """Adopt a KIND_TENSOR payload back into arrays: numpy entries come
    back as READ-ONLY views over the message bytes (the zero-copy
    contract — a consumer that mutates in place must `.copy()` first),
    torch entries as tensors copied out of them, back on the reader's
    CUDA device when written from one (a reader without a card raises).
    Returns (value, extra)."""
    import numpy as np

    buf = memoryview(buf).cast("B")
    container, extra, entries, _ = parse_tensor_header(buf)
    arrays = []
    for e in entries:
        raw = buf[e["offset"]:e["offset"] + e["nbytes"]]
        if e["is_torch"]:
            arrays.append(_adopt_torch(raw, e))
        else:
            arrays.append(np.frombuffer(
                raw, dtype=_np_dtype(e["dtype"])).reshape(e["shape"]))
    if container == _CONT_SINGLE:
        value: Any = arrays[0]
    elif container == _CONT_TUPLE:
        value = tuple(arrays)
    elif container == _CONT_LIST:
        value = arrays
    else:
        value = {e["key"]: a for e, a in zip(entries, arrays)}
    return value, extra


class Channel:
    """SPSC channel; open lazily in each endpoint process.

    `location` is the node id whose store hosts the ring (the reader's
    node).  None, or a location equal to the current process's node,
    means all ops are local; otherwise writes/close/destroy relay
    through the node daemons."""

    def __init__(self, name: str, location: Optional[str] = None,
                 ring_slots: Optional[int] = None,
                 slot_bytes: Optional[int] = None):
        self.name = name
        self.location = location
        self.ring_slots, self.slot_bytes = ring_geometry(
            ring_slots, slot_bytes
        )
        self._h = _chan_hash(name)
        # separate hash domain: a spill key must never collide with the
        # channel's own id (deleting it would destroy the live region)
        self._spill_h = hashlib.blake2b(
            (name + "/spill").encode(), digest_size=16
        ).digest()
        self._read_seq = 0
        self._write_seq = 0
        self._opened = False

    def _is_remote(self) -> bool:
        if self.location is None:
            return False
        from ray_tpu_torch.core.runtime import get_runtime

        return self.location != get_runtime().node_id

    def _store(self):
        from ray_tpu_torch.core.runtime import get_runtime

        store = get_runtime().store
        if not self._opened:
            store.chan_create(self._h, nslots=self.ring_slots,
                              slot_size=self.slot_bytes)
            self._opened = True
        return store

    def _spill_key(self, seq: int) -> bytes:
        return self._spill_h + struct.pack("<H", seq % 65536)

    # -- writer side ---------------------------------------------------
    def _slot_publish(self, store, chunks: List[Any], kind: int,
                      timeout_ms: int):
        """One slot publication, with ring-full accounting: when
        metrics are on, a short first acquire distinguishes "slot free"
        from "ring full, we blocked" without changing the blocking
        semantics the disabled path keeps."""
        if _mdefs.enabled() and (timeout_ms < 0 or timeout_ms > 25):
            try:
                store.chan_write_chunks(self._h, chunks, kind=kind,
                                        timeout_ms=25)
                return
            except TimeoutError:
                _mdefs.inc("rt_dag_channel_ring_full_total")
                remaining = timeout_ms if timeout_ms < 0 else timeout_ms - 25
                store.chan_write_chunks(self._h, chunks, kind=kind,
                                        timeout_ms=max(1, remaining)
                                        if remaining >= 0 else -1)
                return
        store.chan_write_chunks(self._h, chunks, kind=kind,
                                timeout_ms=timeout_ms)

    def _write_chunks(self, chunks: List[Any], total: int, kind: int,
                      timeout_s: float):
        """Local-ring publication of an encoded payload: inline when it
        fits the slot, else raw bytes go to ONE store object and the
        slot carries only the key (same spill rule as pickle payloads,
        so tensor batches of any size ride the same channel)."""
        timeout_ms = max(1, int(timeout_s * 1000))
        store = self._store()
        t0 = time.perf_counter()
        try:
            if total <= self.slot_bytes:
                self._slot_publish(store, chunks, kind, timeout_ms)
            else:
                key = self._spill_key(self._write_seq)
                if store.contains(key):
                    store.delete(key)  # leftover from a failed attempt
                buf = store.create(key, total)
                try:
                    pos = 0
                    for c in chunks:
                        v = memoryview(c).cast("B")
                        buf[pos:pos + v.nbytes] = v
                        pos += v.nbytes
                except BaseException:
                    del buf
                    store.abort(key)  # partial create must not leak
                    raise
                del buf
                store.seal(key)
                try:
                    self._slot_publish(store, [key], SPILL_KIND[kind],
                                       timeout_ms)
                except Exception:
                    store.delete(key)  # unpublished: reclaim it
                    raise
        except ChannelClosedError:
            raise ChannelClosed(self.name) from None
        except TimeoutError:
            raise TimeoutError(
                f"channel {self.name}: reader lagging >{self.ring_slots} "
                "messages behind"
            ) from None
        finally:
            _mdefs.observe("rt_dag_channel_write_seconds",
                           time.perf_counter() - t0)
        self._write_seq += 1

    def write(self, value: Any, kind: int = KIND_DATA,
              timeout_s: float = 120.0):
        if kind == KIND_DATA and as_tensor_batch(value) is not None:
            return self.write_tensors(value, timeout_s=timeout_s)
        if kind == KIND_DATA:
            payload = ser.serialize_to_bytes(value)
        elif kind == KIND_ERROR:
            payload = ser.serialize_to_bytes(value, tag=ser.TAG_ERROR)
        else:
            payload = b""
        if self._is_remote():
            self._remote_write(payload, kind, timeout_s)
            self._write_seq += 1
            return
        self._write_chunks([payload], len(payload), kind, timeout_s)

    def write_tensors(self, value: Any, extra: Any = None,
                      timeout_s: float = 120.0):
        """Publish a tensor batch (array / tuple / list / dict of
        arrays) without pickling the array bytes; `extra` carries a
        small metadata blob alongside (read back by read_tensors)."""
        chunks, total = encode_tensors(value, extra)
        if self._is_remote():
            # relay path: assemble once (the bytes cross a socket
            # anyway) and let the reader-side daemon spill if oversized
            payload = b"".join(
                bytes(c) if not isinstance(c, bytes) else c for c in chunks
            )
            self._remote_write(payload, KIND_TENSOR, timeout_s)
            self._write_seq += 1
            return
        self._write_chunks(chunks, total, KIND_TENSOR, timeout_s)

    def _remote_write(self, payload: bytes, kind: int, timeout_s: float):
        """Relay a write to the ring on `location` through the node
        daemons.  The daemon-side chan write blocks (in a worker
        thread) while the remote ring is full, so backpressure reaches
        this writer through the pending reply."""
        from ray_tpu_torch.core.runtime import get_runtime

        timeout_ms = max(1, int(timeout_s * 1000))
        spill_key = (
            self._spill_key(self._write_seq)
            if len(payload) > self.slot_bytes else None
        )
        t0 = time.perf_counter()
        reply = get_runtime().noded_call(
            "chan_remote_write",
            {
                "node_id": self.location,
                "chan": self._h,
                "kind": kind,
                "payload": payload,
                "spill_key": spill_key,
                "timeout_ms": timeout_ms,
                "ring_slots": self.ring_slots,
                "slot_bytes": self.slot_bytes,
            },
            timeout=timeout_s + 30,
        )
        _mdefs.observe("rt_dag_channel_write_seconds",
                       time.perf_counter() - t0)
        status = (reply or {}).get("status", "error")
        if status == "ok":
            return
        if status == "closed":
            raise ChannelClosed(self.name)
        if status == "timeout":
            _mdefs.inc("rt_dag_channel_ring_full_total")
            raise TimeoutError(
                f"channel {self.name}: reader lagging >{self.ring_slots} "
                "messages behind"
            )
        raise RuntimeError(
            f"remote channel write failed: {(reply or {}).get('error')}"
        )

    def write_error(self, err: BaseException):
        self.write(err, kind=KIND_ERROR)

    def close(self):
        """Send the teardown sentinel, then mark the ring closed (the
        reader drains published messages before seeing closed)."""
        try:
            self.write(None, kind=KIND_SENTINEL, timeout_s=5.0)
        except Exception as e:
            # full-ring/dead-reader sentinels are best effort; the
            # closed mark below still unblocks both endpoints
            logger.debug("channel %s: close sentinel skipped: %s",
                         self.name, e)
        try:
            if self._is_remote():
                self._remote_ring_op("chan_remote_close")
            else:
                self._store().chan_close(self._h)
        except Exception as e:
            logger.debug("channel %s: close failed: %s", self.name, e)

    def _remote_ring_op(self, method: str):
        from ray_tpu_torch.core.runtime import get_runtime

        get_runtime().noded_call(
            method, {"node_id": self.location, "chan": self._h}, timeout=30
        )

    def destroy(self):
        """Free the channel's pinned shm region.  Called at DAG
        teardown AFTER the endpoints exited — channels are allocated
        non-evictable, so without this every compiled DAG would leak
        arena permanently."""
        if self._is_remote():
            try:
                self._remote_ring_op("chan_remote_destroy")
            except Exception as e:
                logger.debug("channel %s: remote destroy failed: %s",
                             self.name, e)
            return
        from ray_tpu_torch.core.runtime import get_runtime

        store = get_runtime().store
        try:
            store.chan_close(self._h)
        except Exception as e:
            logger.debug("channel %s: close-at-destroy failed: %s",
                         self.name, e)
        try:
            store.chan_delete(self._h)
        except Exception as e:
            logger.debug("channel %s: delete failed: %s", self.name, e)

    # -- reader side ---------------------------------------------------
    def read_raw(self, timeout_s: Optional[float] = None) -> Tuple[int, bytes]:
        if self._is_remote():
            raise RuntimeError(
                f"channel {self.name}: ring lives on node "
                f"{self.location}; only that node's processes may read"
            )
        store = self._store()
        timeout_ms = -1 if timeout_s is None else max(1, int(timeout_s * 1000))
        try:
            kind, data = store.chan_read(self._h, timeout_ms=timeout_ms)
        except TimeoutError as e:
            raise ChannelPollTimeout(str(e)) from None
        except ChannelClosedError:
            raise ChannelClosed(self.name) from None
        if kind in INLINE_KIND:
            key = bytes(data)
            view = store.get(key, timeout_ms=timeout_ms)
            try:
                data = bytes(view)
            finally:
                del view
                store.release(key)
                store.delete(key)
            kind = INLINE_KIND[kind]
        self._read_seq += 1
        return kind, data

    def _decode(self, kind: int, payload: bytes) -> Tuple[Any, Any]:
        if kind == KIND_SENTINEL:
            raise ChannelClosed(self.name)
        if kind == _shm.KIND_OVERFLOW_MARKER:
            raise RuntimeError(
                f"channel {self.name}: writer overflowed the slot "
                f"(endpoint ring geometries disagree — the creator's "
                "RTT_DAG_SLOT_BYTES won); message dropped"
            )
        if kind == KIND_TENSOR:
            return decode_tensors(memoryview(payload))
        tag, val = ser.deserialize(memoryview(payload))
        if tag == ser.TAG_ERROR:
            raise val if isinstance(val, BaseException) else RuntimeError(val)
        return val, None

    def read(self, timeout_s: Optional[float] = None) -> Any:
        kind, payload = self.read_raw(timeout_s)
        return self._decode(kind, payload)[0]

    def read_tensors(self, timeout_s: Optional[float] = None
                     ) -> Tuple[Any, Any]:
        """Like read(), but returns (value, extra) so tensor payloads
        hand back the metadata blob their writer attached."""
        kind, payload = self.read_raw(timeout_s)
        return self._decode(kind, payload)
