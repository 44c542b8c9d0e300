"""Single source of truth for every wire/frame layout in the stack.

Until now each layout lived twice (or three times): the ODTP frame header
in wire.py AND bulk.py AND the C++ rendezvous daemon, the chunk meta keys
in ``chunk_fields`` AND ``chunk_span``, the codec alignment rules spread
over compression.py subclasses. A one-byte drift between an encode and its
decode corrupts a multi-GB round silently. This module declares each
layout once; the runtime imports the constants, and the static conformance
pass (analysis/wire_check.py) fails the build when any encode/decode site
-- Python or C++ -- stops matching the declaration.

Nothing here imports numpy: it stays importable in a bare environment.

The port's copy of ``opendiloco_tpu/diloco/schema.py``, constant for
constant: a port worker and a JAX worker read each other's frames.
"""

from __future__ import annotations

import struct

# -- ODTP control/data frame --------------------------------------------------
#
# [4B magic "ODTP"][4B big-endian header_len][header JSON][payload bytes]
# Shared verbatim by the asyncio control plane (wire.py), the threaded bulk
# plane (bulk.py) and the C++ rendezvous daemon (native/odtp_rendezvousd.cpp,
# which the conformance pass greps for the same magic + htonl length).

MAGIC = b"ODTP"
FRAME_HDR_FMT = ">4sI"
FRAME_HDR = struct.Struct(FRAME_HDR_FMT)
FRAME_HDR_SIZE = 8  # must equal struct.calcsize(FRAME_HDR_FMT); pass-checked
MAX_HEADER = 16 * 1024 * 1024

# Logical frame-meta version. v1: flat butterfly push/result frames. v2:
# adds the two-level hierarchical round — stage-suffixed round keys (see
# HIER_STAGES), aggregator-handoff frames, and a plan hash that covers the
# full topology. v2 frames are only emitted inside hierarchical rounds
# (meta["v"] = WIRE_VERSION, checked on receive); flat rounds stay
# byte-identical to v1, so a mixed swarm that never arms ODTP_HIER
# interoperates unchanged. The version is folded into the hierarchical
# plan-hash preimage, so hier frames from a future v3 fail the plan check
# even before the explicit version compare.

WIRE_VERSION = 2
WIRE_VERSION_META_KEY = "v"

# The hierarchical round's stages, in wire order. Each stage's frames ride
# the same push/result machinery under a stage-suffixed round key
# ("<round_key>/<stage>"), so mailbox routing needs no new fields:
#   intra    intra-site reduce-scatter (raw f32 partial sums, codec none)
#   handoff  members ship their site-summed slice to the site aggregator
#   wan      aggregators-only butterfly (configured codec + error feedback)
#   bcast    aggregator broadcasts the averaged flat buffer to its site
HIER_STAGES = ("intra", "handoff", "wan", "bcast")

# single-byte acknowledgement closing every bulk frame exchange
BULK_ACK = b"\x01"

# SO_RCVTIMEO payload on the bulk sockets: a C struct timeval (two native
# longs). Platform-endian by design -- it never crosses the wire.
SO_TIMEVAL_FMT = "ll"

# -- chunk framing (pipelined data plane) -------------------------------------
#
# A pipelined part travels as nchunks frames; the encode side stamps exactly
# these meta keys (wire.chunk_fields) and the decode side reads exactly
# these (wire.chunk_span + tcp.py routing). The conformance pass checks
# both functions against this tuple.

CHUNK_META_FIELDS = ("chunk", "nchunks", "coff", "clen")

# multi-tensor payload packing: per-tensor offset/length keys stamped by
# wire.pack_arrays and popped by wire.unpack_arrays
PACK_META_FIELDS = ("_off", "_len")

# bulk stripe sub-frame header: session id, stripe index, byte length
STRIPE_META_FIELDS = ("session", "stripe", "len")

# -- partition-plan fingerprint ----------------------------------------------
#
# linkstate.plan_hash stamps every push/result frame under meta["plan"];
# both sides must derive it identically or parts silently misalign.

PLAN_HASH_ALGO = "sha1"
PLAN_HASH_HEXLEN = 12
PLAN_META_KEY = "plan"

# -- serving-fleet delta-push frames ------------------------------------------
#
# The fleet push channel (fleet/wire.py) reuses the ODTP frame verbatim:
# [MAGIC][header_len][{"type", "meta", "payload_len"}][payload]. A weight
# push is either a "keyframe" (every leaf, state-codec encoded — the same
# full-snapshot layout install_wire consumes) or a "delta" (one fragment's
# leaves, outer-codec encoded master-minus-shadow). Both carry a "leaves"
# list in meta; each entry slices the concatenated payload:
#
#   {"i": leaf index, "shape": full leaf shape, "off": payload byte offset,
#    "len": payload byte length, "meta": per-leaf codec meta}
#
# "ping" frames carry no payload — they advance the replica's view of the
# trainer epoch so staleness accounting runs even when no weights move.

FLEET_FRAME_KINDS = ("hello", "ping", "keyframe", "delta", "ok", "error")
FLEET_KEYFRAME_META_FIELDS = ("kind", "epoch", "tepoch", "codec", "leaves")
FLEET_DELTA_META_FIELDS = (
    "kind",
    "epoch",
    "tepoch",
    "base_epoch",
    "frag",
    "nfrag",
    "codec",
    "leaves",
)
FLEET_LEAF_META_FIELDS = ("i", "shape", "off", "len", "meta")

# -- per-request trace context ------------------------------------------------
#
# A request entering the serving plane (router or server edge) may carry a
# compact trace context as an OPTIONAL top-level field of its JSON payload
# (HTTP body and JSONL line alike). The field is additive on the existing
# wire: peers that predate it ignore unknown payload fields, so a mixed
# fleet interoperates unchanged — the same version-gating posture as the
# wire v2 meta fields above. The context is a flat dict:
#
#   {"id": trace id (string, globally unique), "o": origin worker/router}
#
# Each hop that records spans for the request keys them by "id" in its own
# process-local request-trace ring (obs/reqtrace.py); cross-process merge
# happens offline (scripts/obs_report.py --reqtrace) by trace id.
#
# "reqtrace" is a pull frame on the control plane: the training worker's
# control port (diloco/tcp.py) and the replica push port (fleet/replica.py)
# both answer it with an "ok" frame whose meta carries the local ring's
# snapshot (per-stage p50/p99 decomposition + inflight/recent traces).
# Old peers answer "error" for the unknown kind; pollers treat that as
# "no reqtrace plane" rather than a failure.

TRACE_CTX_KEY = "trace"
TRACE_CTX_FIELDS = ("id", "o")
REQTRACE_FRAME_KIND = "reqtrace"

# Canonical stage names a request's spans may use, in causal order across
# the serving path. Reports and the odtp_top --requests columns key on
# these; free-form attrs ride each span's "attrs" dict.
#
#   admit       router edge: parse + admission control + candidate choice
#   shed        terminal: rejected at the edge or swept past its deadline
#   forward     one router->replica dispatch round trip (attrs: replica)
#   redispatch  zero-width: the previous forward's replica died mid-flight
#   queue       replica scheduler: submit -> slot admission wait
#   prefill     engine prompt prefill (attrs: bucket, tokens)
#   decode      one batched decode step touching this request (attrs:
#               batch occupancy; spec path adds proposed/accepted)
#   swap        weight hot-swap pause overlapping this request
#   page_out    KV-tier eviction: the slot's ring page copied D2H and
#               encoded into the host tier (attrs: tokens, bytes)
#   page_in     KV-tier restore: paused page decoded + copied H2D back
#               into a free slot (attrs: tokens, bytes)
#   retire      terminal: slot retired (done / failed / cancelled)

REQTRACE_STAGES = (
    "admit",
    "shed",
    "forward",
    "redispatch",
    "queue",
    "prefill",
    "decode",
    "swap",
    "page_out",
    "page_in",
    "retire",
)

# -- codec wire-record geometry ----------------------------------------------
#
# chunk_align: chunk element offsets must be multiples of this (blockwise
# codecs re-derive scales per block; a misaligned chunk re-blocks and stops
# being bit-identical to the whole-tensor encode).
# wire_align_bytes: bulk stripe boundaries round to this many bytes so a
# stripe never splits one encoded wire record.
#
# The conformance pass imports compression.py and fails if a codec class
# drifts from this table (or a new codec ships without declaring itself).

CODEC_WIRE_GEOMETRY: dict[str, tuple[int, int]] = {
    # name: (chunk_align elems, wire_align bytes)
    "none": (1, 4),
    "fp16": (1, 2),
    "scaled-fp16": (1, 2),
    "uniform8bit": (1, 1),
    "quantile8bit": (1, 1),
    "blockwise8bit": (4096, 1),
    "blockwise4bit": (4096, 1),
    "topk": (1, 8),
}
