"""Shared engine tuning constants.

The engine (`repro.core.engine`) and the synchronous façade
(`repro.core.scheduler`) both expose retry/speculation knobs; before this
module existed each hardcoded its own copies and they could drift apart —
a run submitted through `Scheduler` and one submitted through
`ExecutionEngine.submit` would retry/speculate differently. Every default
lives here exactly once.
"""

# fault tolerance: attempts beyond the first before the run is failed
MAX_RETRIES = 2

# straggler speculation: a task is twinned once it runs longer than
# SPECULATION_FACTOR x the median completed-task duration, but never
# earlier than SPECULATION_MIN_S
SPECULATION_FACTOR = 4.0
SPECULATION_MIN_S = 0.5

# partition exchange, skew-aware repartitioning: a shuffle partition whose
# written bytes exceed SKEW_FACTOR x the median partition is re-split into
# row-range sub-partitions before its consumer dispatches (None disables).
# Partitions under SKEW_MIN_BYTES are never split — the re-split overhead
# would dwarf any straggler it prevents.
SKEW_FACTOR = 2.0
SKEW_MIN_BYTES = 1 << 20

# outputs above this spill to a disk-backed mmap channel instead of the
# in-memory table store (per-worker working-set bound)
MMAP_SPILL_BYTES = int(2e9)

# streaming data plane: streamable producers (scans, rowwise functions)
# publish their output as fixed-size row chunks under one chunked
# TableHandle, and stream-capable consumers start on the FIRST chunk
# instead of producer completion. 0 disables chunking for a run.
STREAM_CHUNK_ROWS = 1 << 16

# transport memory budget: resident bytes the in-memory table store may
# hold before cold entries LRU-spill to disk-backed colfiles (restored
# transparently on access). None = unlimited (the pre-budget behavior).
TRANSPORT_MEMORY_BYTES = None

# streamed function outputs are still result-cached (warm re-runs skip
# re-execution) — but only up to this many bytes, so a spill-sized stream
# is never re-concatenated into one resident table just to cache it
STREAM_CACHE_MAX_BYTES = 64 << 20

# ready-heap priority aging: a queued task's run gains +1 effective priority
# per PRIORITY_AGING_S seconds spent waiting, so a sustained stream of
# high-priority runs cannot starve a queued low-priority run forever
# (None disables — the static-priority baseline)
PRIORITY_AGING_S = 5.0

# serving gateway (repro.serving): micro-batching and admission knobs.
# A batch closes at SERVE_MAX_BATCH_REQUESTS coalesced requests or
# SERVE_MAX_BATCH_ROWS total rows, whichever first; the SLO class bounds
# how long the oldest member may wait. The front door admits at most
# SERVE_MAX_PENDING outstanding requests (queued + in flight) and each
# tenant draws from a SERVE_TENANT_RATE req/s token bucket with
# SERVE_TENANT_BURST burst capacity; beyond either bound submissions fail
# fast with AdmissionError instead of growing an unbounded queue.
SERVE_MAX_BATCH_REQUESTS = 8
SERVE_MAX_BATCH_ROWS = 1 << 16
SERVE_MAX_PENDING = 64
SERVE_TENANT_RATE = 200.0
SERVE_TENANT_BURST = 64
SERVE_MAX_INFLIGHT_BATCHES = 8
# response tables cached per gateway for endpoints registered
# idempotent=True, keyed (endpoint, request-table content hash); LRU
SERVE_RESULT_CACHE = 256
