"""Intermediate-dataframe channels (paper §4.3, Table 3).

"As a pipeline is executed, the platform transparently picks a sharing
mechanism: shared memory or local disk (for co-located functions) or Arrow
Flight (across workers)." Four channels, one contract:

  * ``zerocopy``   — same-process shared memory: the child receives the SAME
                     buffers as the parent output (no copy, no serialization).
                     A 10 GB table with three children costs 10 GB, not 30.
  * ``mmap``       — Arrow-IPC-style spill: parent writes one RCF file; each
                     child memory-maps it (zero deserialization; OS page cache
                     shared across children).
  * ``flight``     — Arrow-Flight-style stream: raw column buffers over a
                     localhost TCP socket with a tiny do_get protocol; one
                     copy at the receiver, no (de)serialization.
  * ``objectstore``— the FaaS-platform baseline: serialize a file, PUT it to
                     object storage, child GETs + parses (what Step Functions
                     / Durable Functions force on you).

Column projection is pushed INTO every channel (seekable format / flight
ticket), so differential reads touch only requested bytes.

Streaming data plane (on top of the four):

  * ``chunked``    — an aggregate handle over a producer's fixed-size row
                     chunks, each published through one of the channels above
                     under ``{key}/c{i}``. ``get`` concatenates once at the
                     consumer; ``get_stream`` yields chunks without ever
                     materializing the whole table.
  * ``stream``     — a PROVISIONAL handle the engine hands to a consumer
                     while the producer is still appending: ``get_stream``
                     follows the live stream (a condition variable locally, a
                     chunk-framed flight request remotely) and ends exactly
                     when the producer finishes. An aborted stream surfaces as
                     ``ShardUnavailable`` so recovery re-executes the producer
                     like any lost shard.

The flight wire protocol frames PER CHUNK in both directions (one JSON
header + raw buffers per chunk, then an ``end`` frame), so peak transfer
memory is one chunk even for the legacy whole-table path.

``DataTransport`` also enforces a memory budget: resident zero-copy bytes
are tracked against ``memory_budget_bytes`` and cold entries LRU-spill to
disk-backed colfiles, restored transparently (mmap) on access — observable
through the ``resident_bytes`` / ``spilled_bytes`` / ``restored_bytes``
stats counters.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import threading
import uuid
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.columnar import colfile
from repro_torch.columnar.objectstore import ObjectStore
from repro_torch.columnar.table import Column, ColumnTable, concat_tables
from repro_torch.core import defaults


def _fs_safe(key: str) -> str:
    """Spill filenames derive from table keys; shuffle part keys contain
    '/' ("shuffle:joined/facts#0/p2"), which os.path.join would read as
    directories that don't exist."""
    return key.replace("/", "%2F")


@dataclasses.dataclass(frozen=True)
class TableHandle:
    key: str
    channel: str
    nbytes: int
    num_rows: int
    location: str = ""      # path (mmap/objectstore) or host:port (flight)
    parts: Tuple["TableHandle", ...] = ()   # aggregate channels only


def partitioned_handle(key: str,
                       parts: Sequence[TableHandle]) -> TableHandle:
    """One handle over a sharded producer's outputs. A consumer transport
    resolves each part independently — zero-copy when the part's buffers are
    local, the part's own channel (flight/mmap/objectstore) when remote — and
    concatenates exactly once, at the consumer."""
    parts = tuple(parts)
    if not parts:
        raise ValueError("partitioned handle needs at least one part")
    return TableHandle(key, "partitioned",
                       sum(p.nbytes for p in parts),
                       sum(p.num_rows for p in parts), "", parts)


def shuffle_handle(key: str, parts: Sequence[TableHandle]) -> TableHandle:
    """One shuffle writer's output: P key-addressed partition files. Unlike
    ``partitioned`` (parts = shards of one logical table, consumed together),
    a shuffle handle's parts are addressed INDIVIDUALLY — a per-partition
    consumer fetches ``parts[j]`` from each of many writers and never touches
    the other partitions' bytes."""
    parts = tuple(parts)
    if not parts:
        raise ValueError("shuffle handle needs at least one partition")
    return TableHandle(key, "shuffle",
                       sum(p.nbytes for p in parts),
                       sum(p.num_rows for p in parts), "", parts)


def chunked_handle(key: str, parts: Sequence[TableHandle],
                   location: str = "") -> TableHandle:
    """One streamed producer output: an ordered row-chunk sequence under a
    single handle. ``get`` concatenates the chunks exactly once at the
    consumer (byte-identical to a whole-table put); ``get_stream`` yields
    them one at a time so a chunk-capable consumer never holds the table."""
    parts = tuple(parts)
    if not parts:
        raise ValueError("chunked handle needs at least one chunk")
    return TableHandle(key, "chunked",
                       sum(p.nbytes for p in parts),
                       sum(p.num_rows for p in parts), location, parts)


class ShardUnavailable(ConnectionError):
    """One part of a partitioned read is gone (its producer worker died);
    carries the part key so the engine can re-execute just that shard."""

    def __init__(self, key: str):
        super().__init__(f"shard buffers unavailable: {key}")
        self.key = key


def _iter_chunks(table: ColumnTable, chunk_rows: int) -> Iterator[ColumnTable]:
    """Zero-copy row slices of at most ``chunk_rows`` rows; an empty table
    yields one empty chunk so the schema still travels."""
    if chunk_rows <= 0 or table.num_rows <= chunk_rows:
        yield table
        return
    for start in range(0, table.num_rows, chunk_rows):
        yield table.slice(start, min(chunk_rows, table.num_rows - start))


# ---------------------------------------------------------------------------
# Flight: length-prefixed, chunk-framed do_get over TCP
# ---------------------------------------------------------------------------

_U64 = struct.Struct("<Q")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_U64.pack(len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int, into: Optional[memoryview] = None) -> bytes:
    if into is None:
        buf = bytearray(n)
        into = memoryview(buf)
    else:
        buf = None
    got = 0
    while got < n:
        r = sock.recv_into(into[got:], n - got)
        if r == 0:
            raise ConnectionError("flight peer closed")
        got += r
    return bytes(into) if buf is not None else b""


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _U64.unpack(_recv_exact(sock, 8))
    buf = bytearray(n)
    _recv_exact(sock, n, memoryview(buf))
    return bytes(buf)


def _send_table_chunk(conn: socket.socket, table: ColumnTable,
                      index: int) -> None:
    """One chunk on the wire: a JSON header frame then the raw column
    buffers. The contiguity staging copy (``ascontiguousarray``) is per
    CHUNK — the whole-table path used to stage every buffer of the full
    table before the first byte moved."""
    header: Dict = {"chunk": index, "num_rows": table.num_rows,
                    "columns": []}
    buffers: List[np.ndarray] = []
    for name in table.column_names:
        c = table.column(name)
        spec: Dict = {"name": name, "kind": c.kind, "buffers": []}
        for role, arr in c.buffers().items():
            arr = np.ascontiguousarray(arr)
            spec["buffers"].append({"role": role,
                                    "dtype": str(arr.dtype),
                                    "size": int(arr.nbytes)})
            buffers.append(arr)
        header["columns"].append(spec)
    _send_frame(conn, json.dumps(header).encode())
    for arr in buffers:     # raw buffers — no serialization
        conn.sendall(memoryview(arr).cast("B"))


def _recv_table_chunk(sock: socket.socket, header: Dict) -> ColumnTable:
    """Reassemble one chunk from its header frame + raw buffers."""
    out: Dict[str, Column] = {}
    for spec in header["columns"]:
        bufs = {}
        for b in spec["buffers"]:
            raw = bytearray(b["size"])
            _recv_exact(sock, b["size"], memoryview(raw))
            bufs[b["role"]] = np.frombuffer(raw, dtype=np.dtype(b["dtype"]))
        out[spec["name"]] = Column(spec["kind"], bufs["data"],
                                   bufs.get("offsets"),
                                   bufs.get("validity"))
    return ColumnTable(out)


class FlightServer:
    """Per-worker 'Arrow Flight' endpoint streaming raw column buffers,
    chunk-framed. Tables registered explicitly are served from memory;
    anything else is resolved through the attached transport (resident
    zero-copy tables, budget-spilled colfiles, mmap puts, live streams)."""

    def __init__(self, host: str = "127.0.0.1",
                 chunk_rows: int = defaults.STREAM_CHUNK_ROWS):
        self._tables: Dict[str, ColumnTable] = {}   # guard: _lock
        self._lock = threading.Lock()
        self.chunk_rows = chunk_rows
        self._transport: Optional["DataTransport"] = None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(64)
        self.host, self.port = self._srv.getsockname()
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"flight-{self.port}")
        self._thread.start()

    # -- registry -------------------------------------------------------------
    def attach(self, transport: "DataTransport") -> None:
        """Resolve unregistered keys (and live streams) through `transport`
        instead of pinning strong refs here — a spilled table stays spilled
        even while remote peers read it."""
        self._transport = transport

    def register(self, key: str, table: ColumnTable) -> None:
        with self._lock:
            self._tables[key] = table

    def unregister(self, key: str) -> None:
        with self._lock:
            self._tables.pop(key, None)

    # -- server loop ------------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _lookup(self, key: str) -> Optional[ColumnTable]:
        with self._lock:
            table = self._tables.get(key)
        if table is None and self._transport is not None:
            table = self._transport._local_lookup(key)
        return table

    def _handle(self, conn: socket.socket) -> None:
        try:
            if self._stop:          # killed worker: refuse, don't serve
                return
            req = json.loads(_recv_frame(conn).decode())
            if req.get("stream"):
                self._serve_stream(conn, req["key"], req.get("columns"))
                return
            table = self._lookup(req["key"])
            if table is None:
                _send_frame(conn, json.dumps({"error": "unknown key"}).encode())
                return
            # missing columns are dropped, not an error: a strict projection
            # here would close the connection, which the client must read as
            # a dead shard (see _project_available)
            cols = [c for c in (req.get("columns") or table.column_names)
                    if c in table.column_names]
            table = table.project(cols)
            n = 0
            for chunk in _iter_chunks(table, self.chunk_rows):
                _send_table_chunk(conn, chunk, n)
                n += 1
            _send_frame(conn, json.dumps({"end": n}).encode())
        except (ConnectionError, json.JSONDecodeError, KeyError, OSError):
            pass
        finally:
            conn.close()

    def _serve_stream(self, conn: socket.socket, key: str,
                      columns: Optional[Sequence[str]]) -> None:
        """Follow a live stream: frame each chunk as it lands, end when the
        producer finishes. An aborted/unknown stream gets an error frame the
        client maps to ShardUnavailable."""
        tr = self._transport
        state = tr._stream_state(key) if tr is not None else None
        if state is None:
            _send_frame(conn, json.dumps({"error": "unknown stream"}).encode())
            return
        i = 0
        while not self._stop:
            status, handle = state.next_chunk(i)
            if status == "aborted":
                _send_frame(conn,
                            json.dumps({"error": "stream aborted"}).encode())
                return
            if status == "end":
                _send_frame(conn, json.dumps({"end": i}).encode())
                return
            assert handle is not None
            chunk = tr._resolve_chunk(handle, columns)
            _send_table_chunk(conn, chunk, i)
            i += 1

    def close(self) -> None:
        self._stop = True
        with self._lock:
            self._tables.clear()
        # shutdown() wakes a thread blocked in accept(); close() alone leaves
        # the listening socket alive inside the in-progress syscall, and a
        # "dead" worker would keep serving
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass


def _flight_request(host: str, port: int, key: str,
                    columns: Optional[Sequence[str]],
                    stream: bool = False) -> socket.socket:
    try:
        sock = socket.create_connection((host, port))
    except OSError as e:
        raise ShardUnavailable(key) from e
    try:
        if sock.getsockname() == sock.getpeername():
            # localhost ephemeral-port self-connection (server is gone and
            # TCP simultaneous-open hit our own source port)
            raise ShardUnavailable(key)
        req: Dict = {"key": key,
                     "columns": list(columns) if columns else None}
        if stream:
            req["stream"] = True
        _send_frame(sock, json.dumps(req).encode())
        return sock
    except ShardUnavailable:
        sock.close()
        raise
    except (ConnectionError, OSError) as e:
        sock.close()
        raise ShardUnavailable(key) from e


def flight_get(host: str, port: int, key: str,
               columns: Optional[Sequence[str]] = None) -> ColumnTable:
    """Fetch a registered table from a peer's flight endpoint. The wire is
    chunk-framed — the peer stages/sends one chunk at a time and this side
    holds chunk buffers, concatenated exactly once at the end (a one-chunk
    table reassembles with no extra concat copy).

    Error contract (the remote runtime's recovery paths lean on it):
    a server that knows nothing about the key raises ``KeyError``; every
    transport-level failure — connection refused/reset, the peer closing
    after the do_get header or mid-stream, a garbled header, the localhost
    self-connect artifact — raises ``ShardUnavailable(key)``, never a raw
    socket error. Callers map ShardUnavailable/KeyError to
    HandleUnavailable, which re-executes exactly the lost producer."""
    sock = _flight_request(host, port, key, columns)
    try:
        chunks: List[ColumnTable] = []
        while True:
            header = json.loads(_recv_frame(sock).decode())
            if "error" in header:
                if chunks:
                    # data already flowed: a mid-stream error is a dead
                    # shard, not an unknown key
                    raise ShardUnavailable(key)
                raise KeyError(f"flight: {header['error']} ({key})")
            if "end" in header:
                break
            chunks.append(_recv_table_chunk(sock, header))
        if not chunks:
            raise ShardUnavailable(key)
        return chunks[0] if len(chunks) == 1 else concat_tables(chunks)
    except (ShardUnavailable, KeyError):
        raise
    except (ConnectionError, OSError, json.JSONDecodeError,
            struct.error) as e:
        raise ShardUnavailable(key) from e
    finally:
        sock.close()


def flight_get_stream(host: str, port: int, key: str,
                      columns: Optional[Sequence[str]] = None
                      ) -> Iterator[ColumnTable]:
    """Follow a peer's LIVE stream chunk by chunk: yields each chunk as the
    producer publishes it and returns when the producer finishes. Every
    failure — including an aborted or unknown stream — raises
    ``ShardUnavailable(key)``: a broken stream means re-executing the
    producer, exactly like a lost shard."""
    sock = _flight_request(host, port, key, columns, stream=True)
    try:
        while True:
            header = json.loads(_recv_frame(sock).decode())
            if "error" in header:
                raise ShardUnavailable(key)
            if "end" in header:
                return
            yield _recv_table_chunk(sock, header)
    except ShardUnavailable:
        raise
    except (ConnectionError, OSError, json.JSONDecodeError,
            struct.error) as e:
        raise ShardUnavailable(key) from e
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# live stream state (producer side)
# ---------------------------------------------------------------------------


class _StreamState:
    """Chunk-handle sequence of one in-progress stream. Producers append
    and finish/abort; consumers (local generators and flight server threads)
    block on the condition variable for the next chunk."""

    def __init__(self, key: str):
        self.key = key
        self.cv = threading.Condition()
        self.chunks: List[TableHandle] = []     # guard: cv
        self.finished = False                   # guard: cv
        self.aborted = False                    # guard: cv

    def append(self, handle: TableHandle) -> None:
        with self.cv:
            self.chunks.append(handle)
            self.cv.notify_all()

    def finish(self) -> None:
        with self.cv:
            self.finished = True
            self.cv.notify_all()

    def abort(self) -> None:
        with self.cv:
            self.aborted = True
            self.cv.notify_all()

    def snapshot(self) -> List[TableHandle]:
        with self.cv:
            return list(self.chunks)

    def next_chunk(self, index: int
                   ) -> Tuple[str, Optional[TableHandle]]:
        """Block until chunk `index` exists or the stream settles. Returns
        ("chunk", handle) | ("end", None) | ("aborted", None). Abort wins
        over already-published chunks — a re-executed producer republishes
        everything, so partial reads of a dead attempt must not survive."""
        with self.cv:
            while (len(self.chunks) <= index and not self.finished
                   and not self.aborted):
                self.cv.wait(timeout=0.2)
            if self.aborted:
                return "aborted", None
            if len(self.chunks) > index:
                return "chunk", self.chunks[index]
            return "end", None


class StreamWriter:
    """Producer-side streaming put: ``append`` publishes each fixed-size
    row chunk through the underlying channel (so chunks spill/serve like any
    table), ``finish`` seals the stream into a ``chunked`` TableHandle,
    ``abort`` wakes every consumer with a dead stream."""

    def __init__(self, transport: "DataTransport", key: str, channel: str):
        self._transport = transport
        self.key = key
        self.channel = channel
        self._state = transport._register_stream(key)
        self._index = 0

    @property
    def location(self) -> str:
        return f"{self._transport.flight.host}:{self._transport.flight.port}"

    def append(self, table: ColumnTable) -> TableHandle:
        handle = self._transport.put(f"{self.key}/c{self._index}", table,
                                     self.channel)
        self._index += 1
        self._transport._bump("stream_chunks")
        self._state.append(handle)
        return handle

    def finish(self) -> TableHandle:
        self._state.finish()
        return chunked_handle(self.key, self._state.snapshot(),
                              location=self.location)

    def abort(self) -> None:
        self._state.abort()


# ---------------------------------------------------------------------------
# DataTransport: one façade over all the channels
# ---------------------------------------------------------------------------


# Channel-level column pushdown is an optimization, never the semantic
# contract: deliver the requested columns that exist and let the consumer
# edge's strict projection (runtime._run_function) raise on genuinely
# missing ones. A strict channel-level projection would turn a column typo
# into KeyError/connection-close — which every recovery path reads as a
# dead shard (ShardUnavailable → HandleUnavailable) and answers by
# re-executing the perfectly healthy producer, forever.


def _project_available(table: ColumnTable,
                       columns: Optional[Sequence[str]]) -> ColumnTable:
    if not columns:
        return table
    return table.project([c for c in columns if c in table.column_names])


def _file_columns_available(path: str, columns: Optional[Sequence[str]]
                            ) -> Optional[List[str]]:
    if not columns:
        return None
    names = {c["name"] for c in colfile.read_header(path)["columns"]}
    return [c for c in columns if c in names]


class DataTransport:
    def __init__(self, spill_dir: str, object_store: Optional[ObjectStore] = None,
                 flight: Optional[FlightServer] = None,
                 memory_budget_bytes: Optional[int] =
                 defaults.TRANSPORT_MEMORY_BYTES):
        self.spill_dir = os.path.abspath(spill_dir)
        os.makedirs(self.spill_dir, exist_ok=True)
        self.object_store = object_store
        self.flight = flight or FlightServer()
        self.memory_budget_bytes = memory_budget_bytes
        self._shm: "OrderedDict[str, ColumnTable]" = OrderedDict()  # guard: _lock
        self._spilled: Dict[str, str] = {}      # guard: _lock
        self._files: Dict[str, str] = {}        # guard: _lock
        self._streams: Dict[str, _StreamState] = {}     # guard: _lock
        self._lock = threading.Lock()
        self.stats = {"zerocopy_puts": 0, "mmap_puts": 0, "flight_puts": 0,
                      "objectstore_puts": 0, "gets": 0, "partitioned_gets": 0,
                      "local_parts": 0, "remote_parts": 0,
                      "remote_part_bytes": 0,
                      "stream_puts": 0, "stream_chunks": 0, "stream_gets": 0,
                      "chunked_gets": 0,
                      "resident_bytes": 0, "spilled_bytes": 0,
                      "restored_bytes": 0}      # guard: _lock
        self.flight.attach(self)

    def _bump(self, name: str, by: int = 1) -> None:
        # counters are shared by every concurrent run on this worker; an
        # unlocked += drops updates under contention
        with self._lock:
            self.stats[name] = self.stats.get(name, 0) + by

    # -- memory budget -----------------------------------------------------------
    def _admit(self, key: str, table: ColumnTable) -> None:
        """Track a zero-copy put against the memory budget, LRU-spilling
        cold entries to colfiles once resident bytes exceed it."""
        with self._lock:
            old = self._shm.pop(key, None)
            if old is not None:
                self.stats["resident_bytes"] -= old.nbytes
            self._shm[key] = table
            self.stats["resident_bytes"] += table.nbytes
            self._enforce_budget(keep=key)

    def _enforce_budget(self, keep: str) -> None:
        """(lock held) Spill LRU entries until resident bytes fit the
        budget. The just-admitted `keep` entry survives even when it alone
        exceeds the budget — spilling it immediately would make every get a
        restore. Spill happens under the lock on purpose: dropping the entry
        first and recording the file after would open a window where the key
        resolves nowhere and a healthy producer looks dead."""
        budget = self.memory_budget_bytes
        if budget is None:
            return
        while self.stats["resident_bytes"] > budget and len(self._shm) > 1:
            victim_key = next(iter(self._shm))
            if victim_key == keep:
                break
            victim = self._shm.pop(victim_key)
            path = os.path.join(self.spill_dir,
                                f"spill-{_fs_safe(victim_key)}.rcf")
            colfile.write_table(path, victim)
            self._spilled[victim_key] = path
            self.stats["resident_bytes"] -= victim.nbytes
            self.stats["spilled_bytes"] += victim.nbytes

    def _local_lookup(self, key: str) -> Optional[ColumnTable]:
        """Resolve a key this transport can serve without the network:
        resident zero-copy tables first (refreshing LRU recency), then
        budget-spilled colfiles and mmap puts, memory-mapped back in without
        re-admitting (the OS page cache owns restored bytes, so a restore
        can't re-trigger the spill it came from)."""
        with self._lock:
            table = self._shm.get(key)
            if table is not None:
                self._shm.move_to_end(key)
                return table
            path = self._spilled.get(key) or self._files.get(key)
            spilled = key in self._spilled
        if path is None or not os.path.exists(path):
            return None
        table = colfile.read_table(path, mmap=True)
        if spilled:
            self._bump("restored_bytes", table.nbytes)
        return table

    # -- streams -----------------------------------------------------------------
    def open_stream(self, key: str, channel: str = "zerocopy") -> StreamWriter:
        """Producer-side entry point: publish `key` as a live chunk stream.
        Consumers may start reading (get_stream on a provisional handle)
        before ``finish`` seals the chunked handle."""
        self._bump("stream_puts")
        return StreamWriter(self, key, channel)

    def _register_stream(self, key: str) -> _StreamState:
        with self._lock:
            state = _StreamState(key)
            # a retried producer replaces the old attempt's stream; readers
            # of the dead attempt see it aborted, never a chunk mix
            old = self._streams.get(key)
            self._streams[key] = state
        if old is not None:
            old.abort()
        return state

    def _stream_state(self, key: str) -> Optional[_StreamState]:
        with self._lock:
            return self._streams.get(key)

    def _resolve_chunk(self, handle: TableHandle,
                       columns: Optional[Sequence[str]] = None) -> ColumnTable:
        """(flight server threads) resolve one chunk handle of a served
        stream through the normal channel machinery."""
        return self._get_one(handle, columns)

    def get_stream(self, handle: TableHandle,
                   columns: Optional[Sequence[str]] = None
                   ) -> Iterator[ColumnTable]:
        """Yield a handle's row chunks without materializing the table.

        * ``chunked`` — the sealed form: resolve each chunk in order.
        * ``stream``  — the live form: follow the producer's stream (local
          condition variable, or a chunk-framed flight request when the
          producer is on another worker). Ends when the producer finishes;
          an aborted stream raises ``ShardUnavailable``.
        * anything else — the whole table as one chunk (so chunk-capable
          consumers degrade gracefully on materialized inputs).
        """
        self._bump("stream_gets")
        if handle.channel == "chunked":
            for part in handle.parts:
                yield self._get_one(part, columns)
            return
        if handle.channel == "stream":
            state = self._stream_state(handle.key)
            if state is not None:
                i = 0
                while True:
                    status, chunk_handle = state.next_chunk(i)
                    if status == "aborted":
                        raise ShardUnavailable(handle.key)
                    if status == "end":
                        return
                    assert chunk_handle is not None
                    yield self._get_one(chunk_handle, columns)
                    i += 1
            host, port = handle.location.rsplit(":", 1)
            yield from flight_get_stream(host, int(port), handle.key, columns)
            return
        yield self.get(handle, columns)

    # -- put ---------------------------------------------------------------------
    def put(self, key: str, table: ColumnTable, channel: str) -> TableHandle:
        self._bump(f"{channel}_puts")
        flight_loc = f"{self.flight.host}:{self.flight.port}"
        if channel == "zerocopy":
            # flight-visible for remote children through the server's
            # transport lookup — no strong ref pinned, so the budget can
            # spill this entry even while peers read it
            self._admit(key, table)
            return TableHandle(key, "zerocopy", table.nbytes, table.num_rows,
                               flight_loc)
        if channel == "mmap":
            path = os.path.join(self.spill_dir, f"{_fs_safe(key)}.rcf")
            colfile.write_table(path, table)
            with self._lock:
                self._files[key] = path
            return TableHandle(key, "mmap", table.nbytes, table.num_rows, path)
        if channel == "flight":
            self.flight.register(key, table)
            return TableHandle(key, "flight", table.nbytes, table.num_rows,
                               flight_loc)
        if channel == "objectstore":
            if self.object_store is None:
                raise RuntimeError("objectstore channel requires an ObjectStore")
            tmp = os.path.join(self.spill_dir,
                               f"{_fs_safe(key)}-{uuid.uuid4().hex}.rcf")
            colfile.write_table(tmp, table)
            okey = f"intermediates/{_fs_safe(key)}.rcf"
            self.object_store.put_file(okey, tmp)
            os.remove(tmp)
            return TableHandle(key, "objectstore", table.nbytes,
                               table.num_rows, okey)
        raise ValueError(f"unknown channel {channel!r}")

    # -- get ---------------------------------------------------------------------
    def get(self, handle: TableHandle, columns: Optional[Sequence[str]] = None,
            via: Optional[str] = None) -> ColumnTable:
        """Fetch a table. `via` overrides the edge's preferred channel (the
        planner may colocate a zero-copy edge with a producer that spilled);
        unavailable local paths degrade to flight. `gets` counts logical
        fetches: a partitioned read is one get regardless of part count."""
        self._bump("gets")
        if handle.channel in ("partitioned", "shuffle"):
            return self._get_partitioned(handle, columns)
        if handle.channel == "chunked":
            self._bump("chunked_gets")
            return concat_tables(self.get_parts(handle, columns))
        if handle.channel == "stream":
            # a non-chunk-capable consumer of a live stream: drain it whole
            return concat_tables(list(self.get_stream(handle, columns)))
        return self._get_one(handle, columns, via)

    def _get_one(self, handle: TableHandle,
                 columns: Optional[Sequence[str]] = None,
                 via: Optional[str] = None) -> ColumnTable:
        channel = via or handle.channel
        if channel == "mmap" and handle.channel != "mmap":
            channel = handle.channel    # no spill file exists; use producer's
        if channel == "zerocopy" and handle.channel == "objectstore":
            channel = "objectstore"
        if handle.channel in ("chunked", "stream"):
            channel = handle.channel
        handle = dataclasses.replace(handle, channel=channel)
        if handle.channel == "chunked":
            return concat_tables([self._get_one(p, columns)
                                  for p in handle.parts])
        if handle.channel == "stream":
            return concat_tables(list(self.get_stream(handle, columns)))
        if handle.channel == "zerocopy":
            table = self._local_lookup(handle.key)
            if table is None:  # remote zero-copy degrades to flight
                loc = handle.location or f"{self.flight.host}:{self.flight.port}"
                host, port = loc.rsplit(":", 1)
                return flight_get(host, int(port), handle.key, columns)
            return _project_available(table, columns)
        if handle.channel == "mmap":
            return colfile.read_table(
                handle.location,
                columns=_file_columns_available(handle.location, columns),
                mmap=True)
        if handle.channel == "flight":
            host, port = handle.location.rsplit(":", 1)
            return flight_get(host, int(port), handle.key, columns)
        if handle.channel == "objectstore":
            tmp = os.path.join(self.spill_dir,
                               f"dl-{uuid.uuid4().hex}.rcf")
            self.object_store.get_to_file(handle.location, tmp)
            try:
                return colfile.read_table(
                    tmp, columns=_file_columns_available(tmp, columns),
                    mmap=False)
            finally:
                os.remove(tmp)
        raise ValueError(f"unknown channel {handle.channel!r}")

    def has_local(self, key: str) -> bool:
        """True if this transport holds the key's buffers locally — resident
        in the table store or budget-spilled to its own colfile (either way a
        partitioned read resolves it without the network)."""
        with self._lock:
            return key in self._shm or key in self._spilled

    def get_parts(self, handle: TableHandle,
                  columns: Optional[Sequence[str]] = None
                  ) -> List[ColumnTable]:
        """Resolve a partitioned handle's parts WITHOUT merging them, in
        shard order: the local table store first (zero-copy, no bytes
        moved), the part's own channel otherwise. Remote parts stream
        concurrently (the flight server is thread-per-connection, so latency
        is the slowest transfer, not the sum) with column projection pushed
        into every fetch. This is the combine path's entry point — a
        CombineTask merges aggregation states per part, so concatenation
        would destroy the part boundaries it needs."""
        tables: List[Optional[ColumnTable]] = [None] * len(handle.parts)
        remote: List[Tuple[int, TableHandle]] = []
        for i, part in enumerate(handle.parts):
            local = (self._local_lookup(part.key)
                     if part.channel == "zerocopy" else None)
            if local is not None:
                self._bump("local_parts")
                tables[i] = _project_available(local, columns)
            else:
                remote.append((i, part))
        failures: List[Tuple[str, Exception]] = []

        def _fetch(i: int, part: TableHandle) -> None:
            try:
                tables[i] = self._get_one(part, columns=columns)
                self._bump("remote_parts")
                self._bump("remote_part_bytes", tables[i].nbytes)
            except (OSError, ConnectionError, KeyError) as e:
                failures.append((part.key, e))

        if len(remote) == 1:
            _fetch(*remote[0])
        elif remote:
            threads = [threading.Thread(target=_fetch, args=rp, daemon=True)
                       for rp in remote]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if failures:
            key, cause = failures[0]
            raise ShardUnavailable(key) from cause
        return tables

    def _get_partitioned(self, handle: TableHandle,
                         columns: Optional[Sequence[str]]) -> ColumnTable:
        """Gather: resolve every part (get_parts) and concatenate exactly
        once, here, at the consumer."""
        from repro_torch.columnar import compute

        self._bump("partitioned_gets")
        return compute.concat_tables(self.get_parts(handle, columns))

    # -- shuffle -----------------------------------------------------------------
    def put_shuffle(self, prefix: str, parts: Sequence[ColumnTable],
                    channel: str = "zerocopy") -> TableHandle:
        """Publish a shuffle writer's P partitions as individually addressable
        tables (``{prefix}/p{j}``). Consumers fetch exactly one partition per
        writer via :meth:`get_partition`; the other partitions' bytes never
        move off this worker."""
        handles = [self.put(f"{prefix}/p{j}", part, channel)
                   for j, part in enumerate(parts)]
        return shuffle_handle(prefix, handles)

    def get_partition(self, handles: Sequence[TableHandle],
                      partition_index: int,
                      columns: Optional[Sequence[str]] = None
                      ) -> List[ColumnTable]:
        """Resolve partition ``j`` across MANY shuffle writers, in writer
        order: one slice from each producer, local zero-copy first, remote
        parts streamed concurrently. A dead producer surfaces as
        ``ShardUnavailable(part key)`` so the engine can re-execute exactly
        the writer that held the lost partition."""
        selected: List[TableHandle] = []
        for h in handles:
            if h.channel != "shuffle":
                raise ValueError(f"get_partition needs shuffle handles, "
                                 f"got {h.channel!r} for {h.key}")
            if partition_index >= len(h.parts):
                raise ShardUnavailable(f"{h.key}/p{partition_index}")
            selected.append(h.parts[partition_index])
        synthetic = TableHandle(f"partition:{partition_index}", "partitioned",
                                sum(p.nbytes for p in selected),
                                sum(p.num_rows for p in selected), "",
                                tuple(selected))
        self._bump("partition_gets")
        return self.get_parts(synthetic, columns)

    def evict(self, handle: TableHandle) -> None:
        for part in handle.parts:   # aggregate channels: evict every slice
            self.evict(part)
        spath = None
        with self._lock:
            table = self._shm.pop(handle.key, None)
            if table is not None:
                self.stats["resident_bytes"] -= table.nbytes
            spath = self._spilled.pop(handle.key, None)
            self._files.pop(handle.key, None)
            self._streams.pop(handle.key, None)
        self.flight.unregister(handle.key)
        if spath is not None and os.path.exists(spath):
            os.remove(spath)
        if handle.channel == "mmap" and os.path.exists(handle.location):
            os.remove(handle.location)

    def drop_memory(self) -> None:
        """Forget every resident table and abort live streams (a killed
        worker's consumers must see dead streams, not a hang). Spilled files
        stay — eviction owns their lifecycle."""
        with self._lock:
            self._shm.clear()
            self.stats["resident_bytes"] = 0
            streams = list(self._streams.values())
        for state in streams:
            state.abort()

    def close(self) -> None:
        with self._lock:
            streams = list(self._streams.values())
        for state in streams:
            state.abort()
        self.flight.close()
