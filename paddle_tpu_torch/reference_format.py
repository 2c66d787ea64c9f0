"""Reference-era on-disk artifacts, read and written without a protobuf
runtime.

Parity: the JAX package's reference_format.py, copied so that for the same
program and values the port writes the JAX module's bytes, and each
package loads the other's era-wire export.

The reference serializes programs as the `ProgramDesc` protobuf of
paddle/fluid/framework/framework.proto (written by
python/paddle/fluid/io.py:384 save_inference_model via
`program.desc.serialize_to_string()`), and parameters as the LoDTensor
stream of paddle/fluid/framework/lod_tensor.cc:243 SerializeToStream /
tensor_util.cc:191 TensorToStream (written by operators/save_op.cc, one
file per variable named after it).

This module hand-rolls the protobuf wire format (proto2, only the field
shapes framework.proto actually uses) so a model saved by reference-era
code loads into a Program the port runs, and a model trained here is
written in the layout the reference runtime loads.
"""
import struct

import numpy as np

from .core.framework import Block, Program

__all__ = ["parse_program_desc", "read_lod_tensor_file",
           "read_combined_lod_tensor_file",
           "write_combined_lod_tensor_file",
           "adapt_sequence_layout",
           "strip_feed_fetch",
           "serialize_program_desc", "write_lod_tensor_file",
           "save_reference_inference_model"]


# ---------------------------------------------------------------------------
# protobuf wire primitives (proto2)
# ---------------------------------------------------------------------------

def _varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("malformed varint")


def _fields(buf):
    """Yield (field_number, wire_type, value) over one message's bytes.
    value: int for varint/fixed, bytes for length-delimited."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _varint(buf, pos)
        elif wire == 1:
            v = struct.unpack("<q", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            v = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            v = struct.unpack("<i", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError("unsupported wire type %d" % wire)
        yield field, wire, v


def _sint32(v):
    """proto int32 arrives as a 64-bit varint two's complement."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _repeated_varints(wire, v):
    """A repeated varint field: packed (length-delimited) or one value."""
    if wire == 2:
        out, pos = [], 0
        while pos < len(v):
            x, pos = _varint(v, pos)
            out.append(_sint32(x))
        return out
    return [_sint32(v)]


def _f32(wire, v):
    if wire == 5:
        return struct.unpack("<f", struct.pack("<i", v))[0]
    raise ValueError("expected fixed32 float, wire %d" % wire)


# ---------------------------------------------------------------------------
# framework.proto messages
# ---------------------------------------------------------------------------

_DTYPE = {0: "bool", 1: "int16", 2: "int32", 3: "int64",
          4: "float16", 5: "float32", 6: "float64"}
# era op registrations whose name our registry modernized; applied on
# load (era->ours) via THIS dict in parse_program_desc, and inverted on
# export so the wire always carries the era registration
_ERA_TO_OURS_NAME = {"top_k": "topk"}
_OURS_TO_ERA_NAME = {v: k for k, v in _ERA_TO_OURS_NAME.items()}
# VarType.Type values describing non-dense runtime objects
_LOD_TENSOR, _READER = 7, 15
_FEED_MINIBATCH, _FETCH_LIST = 9, 10


def _parse_tensor_desc(buf):
    dtype, dims = None, []
    for field, wire, v in _fields(buf):
        if field == 1:
            dtype = _DTYPE.get(v, "float32")
        elif field == 2:
            dims.extend(_repeated_varints(wire, v))
    return dtype, dims


def _parse_var_type(buf):
    """VarType -> (type_enum, dtype, dims, lod_level)."""
    t, dtype, dims, lod_level = None, None, None, 0
    for field, wire, v in _fields(buf):
        if field == 1:
            t = v
        elif field == 3:  # LoDTensorDesc
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    dtype, dims = _parse_tensor_desc(v2)
                elif f2 == 2:
                    lod_level = v2
    return t, dtype, dims, lod_level


def _parse_var_desc(buf):
    name, vtype, persistable = None, None, False
    for field, wire, v in _fields(buf):
        if field == 1:
            name = v.decode("utf-8")
        elif field == 2:
            vtype = _parse_var_type(v)
        elif field == 3:
            persistable = bool(v)
    return name, vtype, persistable


def _parse_op_var(buf):
    slot, args = None, []
    for field, wire, v in _fields(buf):
        if field == 1:
            slot = v.decode("utf-8")
        elif field == 2:
            args.append(v.decode("utf-8"))
    return slot, args


def _parse_attr(buf):
    name = None
    atype = None
    vals = {}
    for field, wire, v in _fields(buf):
        if field == 1:
            name = v.decode("utf-8")
        elif field == 2:
            atype = v
        elif field == 3:
            vals["i"] = _sint32(v)
        elif field == 4:
            vals["f"] = _f32(wire, v)
        elif field == 5:
            vals["s"] = v.decode("utf-8")
        elif field == 6:
            vals.setdefault("ints", []).extend(_repeated_varints(wire, v))
        elif field == 7:
            if wire == 2:  # packed floats
                vals.setdefault("floats", []).extend(
                    struct.unpack("<%df" % (len(v) // 4), v))
            else:
                vals.setdefault("floats", []).append(_f32(wire, v))
        elif field == 8:
            vals.setdefault("strings", []).append(v.decode("utf-8"))
        elif field == 10:
            vals["b"] = bool(v)
        elif field == 11:
            vals.setdefault("bools", []).extend(
                [bool(x) for x in _repeated_varints(wire, v)])
        elif field == 12:
            vals["block_idx"] = _sint32(v)
        elif field == 13:
            vals["l"] = _sint32(v)
    # AttrType: INT FLOAT STRING INTS FLOATS STRINGS BOOLEAN BOOLEANS
    #           BLOCK LONG
    pick = {0: vals.get("i"), 1: vals.get("f"), 2: vals.get("s"),
            3: vals.get("ints", []), 4: vals.get("floats", []),
            5: vals.get("strings", []), 6: vals.get("b"),
            7: vals.get("bools", []), 8: vals.get("block_idx"),
            9: vals.get("l")}
    if atype not in pick:
        raise ValueError("unknown AttrType %r for attr %r" % (atype, name))
    return name, pick[atype]


def _parse_op_desc(buf):
    inputs, outputs, attrs = {}, {}, {}
    op_type = None
    for field, wire, v in _fields(buf):
        if field == 1:
            slot, args = _parse_op_var(v)
            inputs[slot] = args
        elif field == 2:
            slot, args = _parse_op_var(v)
            outputs[slot] = args
        elif field == 3:
            op_type = v.decode("utf-8")
        elif field == 4:
            name, value = _parse_attr(v)
            attrs[name] = value
    return op_type, inputs, outputs, attrs


def _parse_block_desc(buf):
    idx, parent, varz, ops = 0, -1, [], []
    for field, wire, v in _fields(buf):
        if field == 1:
            idx = _sint32(v)
        elif field == 2:
            parent = _sint32(v)
        elif field == 3:
            varz.append(_parse_var_desc(v))
        elif field == 4:
            ops.append(_parse_op_desc(v))
    return idx, parent, varz, ops


def _parse_blocks(raw):
    """ProgramDesc bytes -> [(idx, parent, vars, ops)] sorted by idx —
    the single wire-decode both parse_program_desc and strip_feed_fetch
    build on."""
    blocks = []
    for field, wire, v in _fields(raw):
        if field == 1:
            blocks.append(_parse_block_desc(v))
    blocks.sort(key=lambda b: b[0])
    return blocks


def parse_program_desc(raw):
    """ProgramDesc protobuf bytes -> Program (cites framework.proto;
    the writer is python/paddle/fluid/framework.py Program.desc)."""
    blocks = _parse_blocks(raw) if isinstance(raw, (bytes, bytearray)) \
        else raw

    program = Program()
    # Program() starts with block 0; create the rest preserving parents
    for idx, parent, _, _ in blocks[1:]:
        program.create_block(parent_idx=max(parent, 0))
    program.current_block_idx = 0

    for idx, parent, varz, ops in blocks:
        blk = program.blocks[idx]
        for name, vtype, persistable in varz:
            t, dtype, dims, lod_level = vtype if vtype else (
                None, None, None, 0)
            if t in (_FEED_MINIBATCH, _FETCH_LIST):
                continue  # feed/fetch plumbing; the Executor feeds directly
            blk.create_var(
                name=name, shape=tuple(dims) if dims is not None else None,
                dtype=dtype or "float32", lod_level=lod_level or 0,
                persistable=persistable)
        for op_type, ins, outs, attrs in ops:
            if op_type in ("feed", "fetch"):
                continue  # recovered separately by strip_feed_fetch
            # era registrations our registry modernized (top_k -> topk)
            blk.append_op(type=_ERA_TO_OURS_NAME.get(op_type, op_type),
                          inputs=ins, outputs=outs,
                          attrs=attrs, infer_shape=False)
    program.current_block_idx = 0
    return program


def strip_feed_fetch(blocks):
    """Feed/fetch targets of a reference inference ProgramDesc: the names
    wired through its prepended `feed` / appended `fetch` ops
    (python/paddle/fluid/io.py get_feed_targets_names). Accepts the
    _parse_blocks result (or raw bytes)."""
    if isinstance(blocks, (bytes, bytearray)):
        blocks = _parse_blocks(blocks)
    feeds, fetches = [], []
    if blocks:
        _, _, _, ops = blocks[0]  # feed/fetch live in the global block
        for op_type, ins, outs, attrs in ops:
            if op_type == "feed":
                feeds.append((attrs.get("col", len(feeds)),
                              outs["Out"][0]))
            elif op_type == "fetch":
                fetches.append((attrs.get("col", len(fetches)),
                                ins["X"][0]))
    # the era's prepend_feed_ops inserts at block index 0, so a real
    # __model__ lists feed ops col n-1..0 — order by col, not block order
    return [n for _, n in sorted(feeds)], [n for _, n in sorted(fetches)]


# ---------------------------------------------------------------------------
# LoDTensor stream (save_op output, one file per variable)
# ---------------------------------------------------------------------------

def _read_lod_tensor_stream(buf, pos):
    """One LoDTensor stream at buf[pos:] -> (arr, lod, end_pos).

    Layout (lod_tensor.cc SerializeToStream):
      u32 version(0) | u64 lod_level | per level: u64 nbytes + size_t data
      | u32 tensor version(0) | i32 desc_size | TensorDesc proto | raw data
    """
    def u32():
        nonlocal pos
        v = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return v

    def u64():
        nonlocal pos
        v = struct.unpack_from("<Q", buf, pos)[0]
        pos += 8
        return v

    version = u32()
    if version != 0:
        raise ValueError("unsupported LoDTensor version %d" % version)
    lod = []
    for _ in range(u64()):
        nbytes = u64()
        level = np.frombuffer(buf, "<u8", count=nbytes // 8, offset=pos)
        pos += nbytes
        lod.append(level.tolist())
    tversion = u32()
    if tversion != 0:
        raise ValueError("unsupported Tensor version %d" % tversion)
    desc_size = struct.unpack_from("<i", buf, pos)[0]
    pos += 4
    dtype, dims = _parse_tensor_desc(buf[pos:pos + desc_size])
    pos += desc_size
    n = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(buf, np.dtype(dtype), count=n,
                        offset=pos).reshape(dims)
    pos += arr.nbytes
    return arr, lod, pos


def read_lod_tensor_file(path):
    """Parse one reference save_op file -> (np.ndarray, lod levels)."""
    with open(path, "rb") as f:
        buf = f.read()
    arr, lod, end = _read_lod_tensor_stream(buf, 0)
    if end != len(buf):
        raise ValueError(
            "param file %r has %d trailing bytes after the tensor (a "
            "COMBINED save_combine file needs params_filename=...)"
            % (path, len(buf) - end))
    return arr, lod


def read_combined_lod_tensor_file(path, names):
    """Parse a save_combine file (save_combine_op.cc: the named tensors'
    streams CONCATENATED, in sorted-by-name order — the era's io.py:120
    sorts before emitting the op) -> {name: np.ndarray}."""
    with open(path, "rb") as f:
        buf = f.read()
    out, pos = {}, 0
    for name in sorted(names):
        if pos >= len(buf):
            raise ValueError(
                "combined params file %r exhausted before %r (have the "
                "var names changed since save?)" % (path, name))
        arr, _lod, pos = _read_lod_tensor_stream(buf, pos)
        out[name] = arr
    if pos != len(buf):
        raise ValueError(
            "combined params file %r has %d trailing bytes after the "
            "%d named tensors" % (path, len(buf) - pos, len(names)))
    return out


# ---------------------------------------------------------------------------
# layout adaptation: flat LoD rows -> padded-dense + @SEQLEN companions
# ---------------------------------------------------------------------------

# recurrences: attach XLen to Input; sequence-shaped outputs keep the
# segmentation via the generic propagation rule below
_RECURRENT = frozenset(("lstm", "lstmp", "gru"))

# Sequence-RESTRUCTURING ops this adapter does not rewrite: each changes
# the segmentation itself (not just per-step values), so the generic
# "propagate X's lengths to Out" rule below would be silently WRONG for
# them.  Reject at load time instead (ADVICE r4 #2).
_UNHANDLED_SEQ_RESTRUCTURING = frozenset((
    "lod_reset", "sequence_concat", "sequence_slice", "sequence_erase",
    "sequence_reshape", "sequence_pad", "sequence_unpad",
))


def adapt_sequence_layout(program, feed_names):
    """Rewire a loaded reference program from the flat-LoD-rows layout to
    the padded-dense layout (SURVEY §6.3), in place.

    The reference addresses a lod_level-1 tensor as [total_rows, D] and
    carries the segmentation out of band (LoD offsets in the runtime
    tensor). Here the same variable is [num_seqs, max_len, D] plus an
    int32 ``name@SEQLEN`` lengths companion that the Executor feeds
    automatically for LoDTensor feeds. Three rewrites follow from that:

    - row-semantics ops gain a rank: ``mul`` x_num_col_dims += 1, and the
      broadcast/concat axis of ``elementwise_*``/``concat`` += 1 when the
      data is sequence-shaped (a program built through our own layers
      encodes the same thing as fc(num_flatten_dims=2) — layers/nn.py);
    - sequence/recurrence ops (lstm/lstmp/gru/sequence_*) get their
      ``XLen``/``YLen`` input wired to the segmentation companion;
    - segmentation PROPAGATES by the same generic rule Block.append_op
      applies to layer-built programs: every op except the
      ``_LOD_CLEARING_OPS`` (sequence_pool & co) hands its first
      sequence-input's lengths to its outputs — one shared invariant,
      not a second allowlist.

    Cites: lod_tensor.md design + lstm_op.cc (the era's in-op LoD walk
    this replaces). Known limit: ``concat`` with axis=0 on sequence data
    (time-axis concat, i.e. sequence_concat semantics) is not rewritten.
    """
    block = program.global_block()
    seqlen = {}

    def ensure_len_var(name):
        ln = name + "@SEQLEN"
        if ln not in block.vars:
            v = block.create_var(name=ln, shape=(-1,), dtype="int32")
            v.stop_gradient = True
        return ln

    for name in feed_names:
        v = block.vars.get(name)
        if v is not None and getattr(v, "lod_level", 0):
            seqlen[name] = ensure_len_var(name)

    def first(slot_map, slot):
        names = slot_map.get(slot) or []
        return names[0] if names else None

    for op in block.ops:
        t = op.type
        ins_names = [n for ns in op.inputs.values() for n in ns if n]
        # --- reject segmentation-restructuring ops we cannot rewrite ---
        if any(n in seqlen for n in ins_names):
            if t in _UNHANDLED_SEQ_RESTRUCTURING:
                raise ValueError(
                    "adapt_sequence_layout: op %r restructures sequence "
                    "segmentation and is not supported by the layout "
                    "adapter; rebuild this program with the framework's "
                    "own layers instead of loading the reference desc" % t)
            # flat sequence vars are rank-2 [total_rows, D]: axis 0 and
            # its negative alias -2 both denote the time axis
            if t == "concat" and op.attrs.get("axis", 0) in (0, -2):
                raise ValueError(
                    "adapt_sequence_layout: concat with axis=0 on "
                    "sequence data is time-axis concatenation "
                    "(sequence_concat semantics) and is not supported "
                    "by the layout adapter")
        # --- op-specific rank/wiring rewrites --------------------------
        if t == "mul" and first(op.inputs, "X") in seqlen:
            op.attrs["x_num_col_dims"] = \
                op.attrs.get("x_num_col_dims", 1) + 1
        elif t.startswith("elementwise_"):
            x, y = first(op.inputs, "X"), first(op.inputs, "Y")
            if x in seqlen and y not in seqlen:
                ax = op.attrs.get("axis", -1)
                if ax >= 1:
                    op.attrs["axis"] = ax + 1
        elif t == "concat":
            if any(n in seqlen for n in op.inputs.get("X", ()) or ()):
                ax = op.attrs.get("axis", 0)
                if ax >= 1:
                    op.attrs["axis"] = ax + 1
        elif t in _RECURRENT:
            inp = first(op.inputs, "Input")
            if inp in seqlen:
                op.inputs["XLen"] = [seqlen[inp]]
        elif t in ("sequence_pool", "sequence_last_step",
                   "sequence_first_step", "sequence_softmax",
                   "sequence_conv"):
            x = first(op.inputs, "X")
            if x in seqlen:
                op.inputs["XLen"] = [seqlen[x]]
        elif t == "sequence_expand":
            y = first(op.inputs, "Y")
            if y in seqlen:
                op.inputs["YLen"] = [seqlen[y]]
                for o in op.outputs.get("Out", ()) or ():
                    if o:   # expand follows Y's lengths, not X's
                        seqlen[o] = seqlen[y]
        # --- generic segmentation propagation (Block.append_op's rule:
        #     first sequence input wins, clearing ops consume) ----------
        if t not in Block._LOD_CLEARING_OPS:
            src = next((n for n in ins_names if n in seqlen), None)
            if src is not None:
                for ns in op.outputs.values():
                    for o in ns:
                        if o and o not in seqlen:
                            seqlen[o] = seqlen[src]

    for name, ln in seqlen.items():
        v = block.vars.get(name)
        if v is not None:
            # seq_len_var already pointing at the companion means this var
            # was adapted by a previous call — don't bump its rank twice
            already = getattr(v, "seq_len_var", None) == ln
            if not getattr(v, "lod_level", 0):
                v.lod_level = 1
            v.seq_len_var = ln
            # the era DECLARED this var flat ([total_rows, ...]); it now
            # holds the padded layout ([num_seqs, max_len, ...]) — keep
            # the declaration truthful so padded-array feeds pass
            # convert_feeds' rank check and the static analyzer's shape
            # re-inference matches what the lowering actually produces
            if v.shape is not None and not already:
                v.shape = (-1, -1) + tuple(v.shape[1:])
    return program


# ---------------------------------------------------------------------------
# era-format EXPORT: write ProgramDesc protobuf + save_op param files so
# REFERENCE-era deployments can load models trained here. The wire layout
# mirrors this module's own parser (field numbers cited there from
# framework.proto); nothing below is translated reference code.
# ---------------------------------------------------------------------------


# Every op name the reference registers (frozen grep of REGISTER_OP* over
# paddle/fluid/operators/*.cc, minus *_grad — the same snapshot the op
# audit test asserts against; that test imports THIS list). The era
# runtime can only load descs whose op types are in this set.
ERA_REGISTERED_OP_NAMES = frozenset("""
accuracy adadelta adagrad adam adamax array_to_lod_tensor assign
assign_value auc average_accumulates batch_norm beam_search
beam_search_decode bilinear_tensor_product bipartite_match box_coder cast
channel_close channel_create channel_recv channel_send chunk_eval clip
clip_by_norm concat cond conditional_block conv2d conv2d_transpose conv3d
conv3d_transpose conv_shift cos_sim crf_decoding crop cross_entropy
ctc_align cumsum decayed_adagrad delete_var depthwise_conv2d detection_map
dropout edit_distance elementwise_add elementwise_div elementwise_max
elementwise_min elementwise_mul elementwise_pow elementwise_sub expand
feed fetch fill fill_constant fill_constant_batch_size_like
fill_zeros_like ftrl gather gaussian_random
gaussian_random_batch_size_like get_places go gru gru_unit hinge_loss
huber_loss im2sequence increment iou_similarity is_empty l1_norm
label_smooth layer_norm linear_chain_crf listen_and_serv load
load_combine lod_array_length lod_rank_table lod_reset
lod_tensor_to_array log_loss lookup_table lrn lstm lstm_unit lstmp
margin_rank_loss matmul max_pool2d_with_index max_pool3d_with_index
max_sequence_len maxout mean merge_lod_tensor mine_hard_examples minus
modified_huber_loss momentum mul multiclass_nms multiplex nce norm
one_hot pad parallel_do pool2d pool3d positive_negative_pair
precision_recall prelu print prior_box proximal_adagrad proximal_gd
rank_loss read read_from_array recurrent recv reorder_lod_tensor_by_rank
reshape rmsprop rnn_memory_helper roi_pool row_conv save save_combine
scale scatter select send sequence_concat sequence_conv sequence_erase
sequence_expand sequence_pool sequence_reshape sequence_slice
sequence_softmax sgd shrink_rnn_memory sigmoid_cross_entropy_with_logits
sign smooth_l1_loss softmax softmax_with_cross_entropy split
split_lod_tensor split_selected_rows spp squared_l2_distance
squared_l2_norm sum target_assign top_k transpose uniform_random
uniform_random_batch_size_like unpool warpctc while write_to_array
""".split())

_DTYPE_ENUM = {v: k for k, v in _DTYPE.items()}          # name -> enum

# graph-level constructs (sub-block or LoD-structure ops; the JAX
# package's lowering handles them as special rules): an era export of a
# dense inference graph refuses them
_GRAPH_LEVEL_OPS = frozenset((
    "write_to_array", "read_from_array", "lod_array_length",
    "lod_rank_table", "max_sequence_len", "reorder_lod_tensor_by_rank",
    "shrink_rnn_memory", "lod_tensor_to_array", "array_to_lod_tensor",
    "while", "conditional_block", "beam_search", "beam_search_decode",
    "recv"))

# ops the era registers through family MACROS rather than REGISTER_OP
# (REGISTER_ACTIVATION_OP / compare / logical / reduce) — they don't show
# in the REGISTER_OP grep snapshot above but are loadable era types
ERA_MACRO_REGISTERED_NAMES = frozenset("""
sigmoid logsigmoid exp relu tanh tanh_shrink softshrink sqrt abs ceil
floor cos sin round reciprocal log square softplus softsign brelu
leaky_relu soft_relu elu relu6 pow stanh hard_shrink thresholded_relu
hard_sigmoid swish
less_than less_equal greater_than greater_equal equal not_equal
logical_and logical_or logical_xor logical_not
reduce_sum reduce_mean reduce_max reduce_min reduce_prod
""".split())


def _w_varint(v):
    out = b""
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _w_tag(field, wire):
    return _w_varint((field << 3) | wire)


def _w_ld(field, payload):
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return _w_tag(field, 2) + _w_varint(len(payload)) + payload


def _w_vi(field, v):
    return _w_tag(field, 0) + _w_varint(v)


def _encode_wire_attr(name, value):
    """One OpDesc.Attr message. AttrType order mirrors _parse_attr's pick
    table: INT FLOAT STRING INTS FLOATS STRINGS BOOLEAN BOOLEANS BLOCK
    LONG."""
    out = _w_ld(1, name)
    if isinstance(value, bool):            # before int: bool IS int
        return out + _w_vi(2, 6) + _w_vi(10, int(value))
    if isinstance(value, (int, np.integer)):
        v = int(value)
        if not (-(1 << 31) <= v < (1 << 31)):
            # outside int32: the era's proto2 parser would silently
            # truncate an INT varint — emit AttrType LONG (field 13)
            return out + _w_vi(2, 9) + _w_vi(13, v & ((1 << 64) - 1))
        return out + _w_vi(2, 0) + _w_vi(3, v)
    if isinstance(value, (float, np.floating)):
        return out + _w_vi(2, 1) + _w_tag(4, 5) + struct.pack(
            "<f", float(value))
    if isinstance(value, str):
        return out + _w_vi(2, 2) + _w_ld(5, value)
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if not vals:
            # an empty list has no observable element type; the era's
            # OpDesc type check compares declared AttrType, so writing a
            # guessed type would be wrong — omit the attr entirely (a
            # repeated proto2 field left unset reads back as empty, and
            # era ops' list attrs SetDefault to empty)
            return None
        if all(isinstance(x, bool) for x in vals) and vals:
            return out + _w_vi(2, 7) + _w_ld(
                11, b"".join(_w_varint(int(x)) for x in vals))
        if all(isinstance(x, (int, np.integer)) for x in vals):
            return out + _w_vi(2, 3) + _w_ld(
                6, b"".join(_w_varint(int(x) & ((1 << 64) - 1))
                            for x in vals))
        if all(isinstance(x, (float, np.floating)) for x in vals):
            return out + _w_vi(2, 4) + _w_ld(
                7, struct.pack("<%df" % len(vals),
                               *[float(x) for x in vals]))
        if all(isinstance(x, str) for x in vals):
            return out + _w_vi(2, 5) + b"".join(
                _w_ld(8, x) for x in vals)
    raise ValueError(
        "cannot encode attr %r=%r (%s) in the era wire format"
        % (name, value, type(value).__name__))


def _encode_wire_var(var, var_type=7):
    """VarDesc: name, VarType{type, LoDTensorDesc{TensorDesc, lod}},
    persistable."""
    body = _w_vi(1, var_type)
    if var_type == 7:       # LOD_TENSOR
        dims = var.shape if var.shape is not None else ()
        dtype = var.dtype or "float32"
        if dtype not in _DTYPE_ENUM:
            # loud-failure rule (same as _write_lod_tensor_stream): a
            # silent FP32 fallback would write a wrong data_type into the
            # exported desc — e.g. uint8 image-feed vars
            raise ValueError(
                "era export: var %r has dtype %r with no era VarType "
                "data_type enum — the reference runtime cannot load it"
                % (var.name, dtype))
        tensor = _w_vi(1, _DTYPE_ENUM[dtype])
        tensor += b"".join(
            _w_vi(2, int(d) & ((1 << 64) - 1)) for d in dims)
        lodt = _w_ld(1, tensor)
        if getattr(var, "lod_level", 0):
            lodt += _w_vi(2, int(var.lod_level))
        body += _w_ld(3, lodt)
    out = _w_ld(1, var.name) + _w_ld(2, body)
    if var.persistable:
        out += _w_vi(3, 1)
    return out


def _encode_wire_op(op_type, inputs, outputs, attrs):
    out = _w_ld(3, op_type)
    for slot, args in inputs.items():
        out += _w_ld(1, _w_ld(1, slot) + b"".join(
            _w_ld(2, a) for a in args))
    for slot, args in outputs.items():
        out += _w_ld(2, _w_ld(1, slot) + b"".join(
            _w_ld(2, a) for a in args))
    for k in sorted(attrs):
        if k.startswith("__"):
            continue        # internal bookkeeping, never on the era wire
        enc = _encode_wire_attr(k, attrs[k])
        if enc is not None:
            out += _w_ld(4, enc)
    return out


def _deadapt_for_wire(blk):
    """The inverse of adapt_sequence_layout, computed per-op for the
    wire: padded-dense sequence wiring (@SEQLEN companions, XLen/OutLen
    slots, rank-bumped mul/elementwise/concat attrs, [B, T, ...] var
    dims) becomes the era's flat-LoD-rows convention. Returns
    (seq_names, skip_vars, op_view) where op_view(op) -> (inputs,
    outputs, attrs) era-shaped, or raises for sequence ops outside the
    adapter's handled set (the same set the import side rewires)."""
    seq = {n for n, v in blk.vars.items() if getattr(v, "lod_level", 0)}
    skip = {getattr(v, "seq_len_var", None) for v in blk.vars.values()}
    skip.discard(None)

    def _strip_len_slots(slot_map, op_type):
        """Drop every slot that refers exclusively to @SEQLEN companion
        vars (XLen/OutLen/YLen/DetectLen/... — driven by the skip set,
        not a name allowlist); a slot mixing companion and real names
        has no era form."""
        out = {}
        for s, names in slot_map.items():
            hits = [n in skip for n in names if n]
            if hits and all(hits):
                continue
            if any(hits):
                raise ValueError(
                    "era export: op %r slot %r mixes sequence-length "
                    "companions with data vars" % (op_type, s))
            out[s] = list(names)
        return out

    def op_view(op):
        t = op.type
        ins = _strip_len_slots(op.inputs, t)
        outs = _strip_len_slots(op.outputs, t)
        attrs = dict(op.attrs)
        ins_names = [n for ns in ins.values() for n in ns if n]
        if any(n in seq for n in ins_names):
            if t in _UNHANDLED_SEQ_RESTRUCTURING:
                raise ValueError(
                    "era export: sequence op %r is outside the layout "
                    "adapter's handled set" % t)
            # The load-side adapter only ever PRODUCES the padded attr
            # values inverted here (mul >=2, elementwise/concat axis
            # >=2); a padded value outside that range (e.g. time-axis
            # concat at axis 1) has no flat-era preimage — writing it
            # would silently change semantics on the era side AND on
            # re-import. Refuse loudly instead.
            if t == "mul" and ins.get("X", [None])[0] in seq:
                ncd = attrs.get("x_num_col_dims", 1)
                if ncd < 2:
                    raise ValueError(
                        "era export: mul over sequence %r with "
                        "x_num_col_dims=%d has no flat-era preimage"
                        % (ins["X"][0], ncd))
                attrs["x_num_col_dims"] = ncd - 1
            elif t.startswith("elementwise_"):
                x = ins.get("X", [None])[0]
                y = ins.get("Y", [None])[0]
                if x in seq and y not in seq:
                    ax = attrs.get("axis", -1)
                    if ax == 1:
                        raise ValueError(
                            "era export: elementwise %s over sequence "
                            "%r broadcasts along the padded TIME axis "
                            "(axis=1) — no flat-era preimage" % (t, x))
                    if ax >= 2:
                        attrs["axis"] = ax - 1
            elif t == "concat":
                ax = attrs.get("axis", 0)
                if ax in (1, -2):
                    raise ValueError(
                        "era export: concat along the padded TIME axis "
                        "is sequence_concat semantics — no flat-era "
                        "preimage")
                if ax >= 2:
                    attrs["axis"] = ax - 1
        return ins, outs, attrs

    return seq, skip, op_view


class _OpStub(object):
    """Era-composition op produced by _decompose_for_era (quacks like
    Operator for the wire encoder / op_view)."""

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs


class _TmpLike(object):
    """Wire view of a decomposition temporary: dtype/lod follow an
    existing var; sequence sources get the era FLAT dims directly
    ([B, T, ...] -> [-1, ...]) since this view bypasses the _FlatView
    path real seq vars take."""

    def __init__(self, name, src):
        self.name = name
        self.dtype = src.dtype
        self.lod_level = getattr(src, "lod_level", 0)
        if self.lod_level and src.shape is not None \
                and len(src.shape) >= 2:
            self.shape = (-1,) + tuple(src.shape[2:])
        else:
            self.shape = src.shape
        self.persistable = False


def _decompose_for_era(op, blk, alloc_name):
    """Rewrite a fused parity op into the era op COMPOSITION the
    reference-era layer would have emitted (the export-side analogue of
    the parity layers). Returns ([(type, ins, outs, attrs)], new_vars)
    or None when `op` needs no decomposition. new_vars: [(name,
    like_existing_var_name)] temporaries to declare on the wire."""
    t = op.type
    if t == "square_error_cost":
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        out = op.outputs["Out"][0]
        tmp = alloc_name(out + ".sub")
        return ([("elementwise_sub", {"X": [x], "Y": [y]},
                  {"Out": [tmp]}, {}),
                 ("square", {"X": [tmp]}, {"Out": [out]}, {})],
                [(tmp, x)])
    if t in ("sequence_first_step", "sequence_last_step"):
        pooltype = "FIRST" if t == "sequence_first_step" else "LAST"
        return ([("sequence_pool", dict(op.inputs),
                  dict(op.outputs),
                  {"pooltype": pooltype})], [])
    if t == "log_softmax":
        x = op.inputs["X"][0]
        out = op.outputs["Out"][0]
        tmp = alloc_name(out + ".sm")
        return ([("softmax", {"X": [x]}, {"Out": [tmp]}, {}),
                 ("log", {"X": [tmp]}, {"Out": [out]}, {})],
                [(tmp, x)])
    if t in ("squeeze", "unsqueeze"):
        x = op.inputs["X"][0]
        xv = blk.vars.get(x)
        if xv is not None and getattr(xv, "lod_level", 0):
            # the padded output shape has no flat-era preimage — same
            # refusal rule as the padded mul/concat attrs
            raise ValueError(
                "era export: %s over sequence %r would bake padded "
                "dims into an era reshape — no flat-era preimage"
                % (t, x))
        out = op.outputs["Out"][0]
        v = blk.vars.get(out)
        shape = None if v is None else v.shape
        if shape is None or sum(1 for d in shape if d == -1) > 1:
            raise ValueError(
                "era export: %s with non-static output shape %r cannot "
                "decompose to era reshape" % (t, shape))
        return ([("reshape", {"X": list(op.inputs["X"])},
                  {"Out": [out]},
                  {"shape": [int(d) for d in shape]})], [])
    return None


def serialize_program_desc(program, feed_names, fetch_names):
    """Program (single-block inference graph) -> era ProgramDesc bytes,
    with the feed/fetch plumbing the era's save_inference_model prepends
    and appends (feed ops listed col n-1..0, the real serializer's
    insert-at-0 order our own strip_feed_fetch handles). Sequence
    programs are de-adapted to the era's flat-LoD-rows convention — the
    exact inverse of what adapt_sequence_layout applies on load."""
    # prune() empties orphaned sub-blocks but keeps their slots so
    # attrs['sub_block'] indices stay stable — an empty trailing block
    # is fine; a NON-empty one means live control flow we can't encode
    for b in program.blocks[1:]:
        if b.ops or b.vars:
            raise ValueError(
                "era export handles single-block inference programs; "
                "block %d still carries ops/vars (export the pruned "
                "inference program)" % b.idx)
    blk = program.global_block()
    # idx 0, parent -1 (64-bit two's-complement varint, as the era wrote)
    body = _w_vi(1, 0) + _w_tag(2, 0) + _w_varint((1 << 64) - 1)
    # feed/fetch carrier vars: persistable=True like the era's
    # prepend_feed_ops/append_fetch_ops wrote them — the era C++ executor
    # creates non-persistable vars in a per-run LOCAL scope, so a
    # non-persistable 'feed' var would shadow the outer-scope one
    # SetFeedVariable filled (feed_list.at(col) out-of-range) and fetch
    # results would land in the discarded local scope
    class _FV:
        def __init__(self, name):
            self.name, self.persistable = name, True
    body += _w_ld(3, _encode_wire_var(_FV("feed"), var_type=9))
    body += _w_ld(3, _encode_wire_var(_FV("fetch"), var_type=10))
    seq_names, skip_vars, op_view = _deadapt_for_wire(blk)

    class _FlatView:
        """Era dims for a padded sequence var: [B, T, ...] -> [-1, ...]
        flat rows (the dims adapt_sequence_layout re-pads on load)."""
        def __init__(self, v):
            self.name, self.dtype = v.name, v.dtype
            self.persistable = v.persistable
            self.lod_level = v.lod_level
            self.shape = ((-1,) + tuple(v.shape[2:])) \
                if v.shape is not None and len(v.shape) >= 2 else v.shape

    for name in sorted(blk.vars):
        if name in skip_vars:
            continue        # @SEQLEN companions never existed in the era
        v = blk.vars[name]
        if getattr(v, "type", None) in ("tensor_array", "rank_table"):
            raise ValueError(
                "era export supports dense inference graphs; var %r has "
                "runtime type %r" % (name, v.type))
        body += _w_ld(3, _encode_wire_var(
            _FlatView(v) if name in seq_names else v))
    # feed ops inserted at index 0 each -> serialized order col n-1..0
    for col in range(len(feed_names) - 1, -1, -1):
        body += _w_ld(4, _encode_wire_op(
            "feed", {"X": ["feed"]}, {"Out": [feed_names[col]]},
            {"col": col}))
    tmp_counter = [0]

    def _alloc_name(base):
        tmp_counter[0] += 1
        return "%s.era%d" % (base, tmp_counter[0])

    wire_ops = []
    extra_vars = []
    for op in blk.ops:
        if op.type == "grad_of":
            raise ValueError("era export takes the INFERENCE program; "
                             "prune the backward first")
        if op.type in _GRAPH_LEVEL_OPS:
            raise ValueError(
                "era export supports dense inference graphs; op %r is a "
                "graph-level (sub-block / LoD-structure) construct"
                % op.type)
        dec = _decompose_for_era(op, blk, _alloc_name)
        if dec is not None:
            sub_ops, new_vars = dec
            extra_vars.extend(new_vars)
            wire_ops.extend(
                (_OpStub(t2, i2, o2, a2), op) for t2, i2, o2, a2 in sub_ops)
        else:
            wire_ops.append((op, op))
    for tmp_name, like in extra_vars:
        src = blk.vars[like]
        body += _w_ld(3, _encode_wire_var(_TmpLike(tmp_name, src)))

    for op, src_op in wire_ops:
        # our registry uses a few modernized names; the wire must carry
        # the era registration (the load side aliases back)
        wire_type = _OURS_TO_ERA_NAME.get(op.type, op.type)
        if wire_type not in ERA_REGISTERED_OP_NAMES and \
                wire_type not in ERA_MACRO_REGISTERED_NAMES:
            # A desc naming a non-era op type would be unloadable by the
            # reference runtime — refuse at write time. Covers both a
            # framework-native addition (fused_attention, pipeline, moe, ...)
            # and the handful of this framework's FUSED parity lowerings
            # of era APIs (square_error_cost, l2_normalize, ...) that
            # the era expressed as op compositions; lowering those to
            # era compositions at export is not implemented.
            raise ValueError(
                "era export: op %r has no era registration (it is "
                "either a framework-native addition or a fused parity "
                "lowering the era expressed as an op composition) — "
                "express the inference head with primitive era ops to "
                "export" % src_op.type)
        w_ins, w_outs, w_attrs = op_view(op)
        body += _w_ld(4, _encode_wire_op(wire_type, w_ins, w_outs,
                                         w_attrs))
    for col, name in enumerate(fetch_names):
        body += _w_ld(4, _encode_wire_op(
            "fetch", {"X": [name]}, {"Out": ["fetch"]}, {"col": col}))
    return _w_ld(1, body)


def _write_lod_tensor_stream(f, arr, lod=None):
    """One save_op stream (the exact inverse of _read_lod_tensor_stream):
    u32 version | u64 lod levels (+ per-level u64 nbytes + offsets) |
    u32 tensor version | i32 desc size | TensorDesc | raw data."""
    arr = np.ascontiguousarray(arr)
    desc = _w_vi(1, _DTYPE_ENUM[str(arr.dtype)]) + b"".join(
        _w_vi(2, d) for d in arr.shape)
    f.write(struct.pack("<I", 0))
    levels = lod or []
    f.write(struct.pack("<Q", len(levels)))
    for level in levels:
        level = np.asarray(level, "<u8")
        f.write(struct.pack("<Q", level.nbytes))
        f.write(level.tobytes())
    f.write(struct.pack("<I", 0))
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    f.write(arr.tobytes())


def write_lod_tensor_file(path, arr, lod=None):
    with open(path, "wb") as f:
        _write_lod_tensor_stream(f, arr, lod)


def write_combined_lod_tensor_file(path, name_to_array):
    """save_combine layout: the tensors' streams concatenated in
    sorted-by-name order (matching the era's io.py sort and
    read_combined_lod_tensor_file)."""
    with open(path, "wb") as f:
        for name in sorted(name_to_array):
            _write_lod_tensor_stream(f, name_to_array[name])


def save_reference_inference_model(dirname, feeded_var_names, target_vars,
                                   executor, main_program=None,
                                   scope=None, model_filename=None,
                                   params_filename=None):
    """Era-format save_inference_model: __model__ ProgramDesc protobuf +
    one save_op-layout file per persistable param — a directory the
    REFERENCE runtime (and this framework's load_reference_model) can
    serve. The era counterpart wrote the same layout from C++
    (save_op + Program.desc serialization)."""
    import os as _os
    from .core.executor import global_scope, to_numpy
    from .core.framework import default_main_program

    program = main_program if main_program is not None \
        else default_main_program()
    targets = [t if isinstance(t, str) else t.name for t in target_vars]
    inference = program.prune(
        [program.global_block().var(t) for t in targets], for_test=True)
    scope = scope if scope is not None else global_scope()

    _os.makedirs(dirname, exist_ok=True)
    with open(_os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(serialize_program_desc(
            inference, list(feeded_var_names), targets))
    params = {}
    for v in inference.global_block().vars.values():
        if not v.persistable:
            continue
        val = scope.get(v.name)
        if val is None:
            raise ValueError(
                "persistable var %r has no value in the scope — run the "
                "startup program (or load params) first" % v.name)
        params[v.name] = to_numpy(val)
    if params_filename:
        # save_combine: one file, streams in sorted-name order
        write_combined_lod_tensor_file(
            _os.path.join(dirname, params_filename), params)
    else:
        for name, val in params.items():
            write_lod_tensor_file(_os.path.join(dirname, name), val)
    return inference
