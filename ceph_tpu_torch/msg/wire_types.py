"""Typed wire codecs for the hot-path messages (MOSDOp discipline).

The reference gives every load-bearing message a hand-coded versioned
encoding (src/messages/MOSDOp.h, MOSDRepOp.h, MOSDPing.h) under the
denc ENCODE_START/FINISH envelope; rare control messages can afford a
generic path.  Same split here: the five messages that carry client
I/O, replication, and liveness get explicit field layouts with a
struct version (so fields can be added compatibly), and everything
else rides the generic tagged-value denc encoding (common/denc.py) --
either way the wire carries NO JSON (hot-path frames would otherwise pay
json.dumps/loads per message).

Each codec encodes the message's *stable* fields with fixed layout and
carries any remaining keys in a generic-value `extras` dict, so a new
field never silently vanishes; promotion into the fixed layout is a
struct_v bump.
"""

from __future__ import annotations

from ..common.denc import Decoder, Encoder


def _split(data: dict, known: tuple) -> dict:
    """Keys outside the fixed layout -- plus fixed keys whose value is
    None, which the optional-field encoding cannot distinguish from
    absent; the generic extras dict carries them exactly."""
    return {k: v for k, v in data.items()
            if k not in known or v is None}


def _opt(out: dict, key: str, v) -> None:
    """Set only present fields so decode(encode(d)) == d exactly --
    handlers distinguish a missing key from a default value."""
    if v is not None:
        out[key] = v


# -- MOSDOp (client -> primary) ----------------------------------------------

_OP_FIELDS = ("pgid", "oid", "ops", "tid", "reqid")


def _enc_osd_op(enc: Encoder, d: dict) -> None:
    enc.start(1, 1)
    enc.optional(d.get("pgid"), Encoder.string)
    enc.optional(d.get("oid"), Encoder.string)
    enc.optional(d.get("tid"), Encoder.u64)
    reqid = d.get("reqid")
    enc.boolean(reqid is not None)
    if reqid is not None:
        enc.string(str(reqid[0]))
        enc.u64(int(reqid[1]))
    enc.optional(d.get("ops"), Encoder.value)
    enc.value(_split(d, _OP_FIELDS))
    enc.finish()


def _dec_osd_op(dec: Decoder) -> dict:
    dec.start(1)
    out = {}
    _opt(out, "pgid", dec.optional(Decoder.string))
    _opt(out, "oid", dec.optional(Decoder.string))
    _opt(out, "tid", dec.optional(Decoder.u64))
    if dec.boolean():
        out["reqid"] = [dec.string(), dec.u64()]
    _opt(out, "ops", dec.optional(Decoder.value))
    out.update(dec.value())
    dec.finish()
    return out


# -- MOSDOpReply (primary -> client) ------------------------------------------

_OPREPLY_FIELDS = ("tid", "epoch", "err", "results")


def _enc_osd_op_reply(enc: Encoder, d: dict) -> None:
    enc.start(1, 1)
    enc.optional(d.get("tid"), Encoder.u64)
    enc.optional(d.get("epoch"), Encoder.u64)
    enc.optional(d.get("err"), Encoder.string)
    enc.optional(d.get("results"), Encoder.value)
    enc.value(_split(d, _OPREPLY_FIELDS))
    enc.finish()


def _dec_osd_op_reply(dec: Decoder) -> dict:
    dec.start(1)
    out = {}
    _opt(out, "tid", dec.optional(Decoder.u64))
    _opt(out, "epoch", dec.optional(Decoder.u64))
    _opt(out, "err", dec.optional(Decoder.string))
    _opt(out, "results", dec.optional(Decoder.value))
    out.update(dec.value())
    dec.finish()
    return out


# -- MOSDRepOp / reply (primary <-> replica) ----------------------------------

# log_only rides the extras dict: its absent/False/True tri-state (and
# any future non-bool value) must round-trip exactly
_REPOP_FIELDS = ("pgid", "entry", "muts", "tid")


def _enc_rep_op(enc: Encoder, d: dict) -> None:
    enc.start(1, 1)
    enc.optional(d.get("pgid"), Encoder.string)
    enc.optional(d.get("tid"), Encoder.u64)
    enc.optional(d.get("entry"), Encoder.value)
    enc.optional(d.get("muts"), Encoder.value)
    enc.value(_split(d, _REPOP_FIELDS))
    enc.finish()


def _dec_rep_op(dec: Decoder) -> dict:
    dec.start(1)
    out = {}
    _opt(out, "pgid", dec.optional(Decoder.string))
    _opt(out, "tid", dec.optional(Decoder.u64))
    _opt(out, "entry", dec.optional(Decoder.value))
    _opt(out, "muts", dec.optional(Decoder.value))
    out.update(dec.value())
    dec.finish()
    return out


_REPREPLY_FIELDS = ("tid", "from_osd")


def _enc_rep_op_reply(enc: Encoder, d: dict) -> None:
    enc.start(1, 1)
    enc.optional(d.get("tid"), Encoder.u64)
    enc.optional(d.get("from_osd"), Encoder.i64)
    enc.value(_split(d, _REPREPLY_FIELDS))
    enc.finish()


def _dec_rep_op_reply(dec: Decoder) -> dict:
    dec.start(1)
    out = {}
    _opt(out, "tid", dec.optional(Decoder.u64))
    _opt(out, "from_osd", dec.optional(Decoder.i64))
    out.update(dec.value())
    dec.finish()
    return out


# -- MOSDPing / reply (liveness mesh) -----------------------------------------

_PING_FIELDS = ("from_osd", "stamp")


def _enc_osd_ping(enc: Encoder, d: dict) -> None:
    enc.start(1, 1)
    enc.optional(d.get("from_osd"), Encoder.i64)
    enc.optional(d.get("stamp"), Encoder.f64)
    enc.value(_split(d, _PING_FIELDS))
    enc.finish()


def _dec_osd_ping(dec: Decoder) -> dict:
    dec.start(1)
    out = {}
    _opt(out, "from_osd", dec.optional(Decoder.i64))
    _opt(out, "stamp", dec.optional(Decoder.f64))
    out.update(dec.value())
    dec.finish()
    return out


WIRE_CODECS = {
    "osd_op": (_enc_osd_op, _dec_osd_op),
    "osd_op_reply": (_enc_osd_op_reply, _dec_osd_op_reply),
    "rep_op": (_enc_rep_op, _dec_rep_op),
    "rep_op_reply": (_enc_rep_op_reply, _dec_rep_op_reply),
    "osd_ping": (_enc_osd_ping, _dec_osd_ping),
    # ping and its echo deliberately share one layout (MOSDPing
    # carries both directions upstream)
    # lint: disable=denc-symmetry -- shared ping layout
    "osd_ping_reply": (_enc_osd_ping, _dec_osd_ping),
}
