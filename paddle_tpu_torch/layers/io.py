"""Data-input layers.

Parity: python/paddle/fluid/layers/io.py and the JAX package's
layers/io.py — `data` declares a feed Variable (batch dim prepended as -1,
like the reference's append_batch_size); open_recordio_file / open_files,
the reader decorators and read_file mirror layers/io.py:262-366 (reader
state is host-side, run by the Executor's io pre-pass: core/readers.py).
ListenAndServ, Send and Recv (the parameter-server markers) come with
ROADMAP A10 and raise.
"""
from ..core import unique_name
from ..core.framework import default_main_program, default_startup_program

__all__ = ["data", "Send", "Recv", "ListenAndServ",
           "open_recordio_file", "open_files", "read_file",
           "create_shuffle_reader", "create_double_buffer_reader",
           "create_multi_pass_reader", "shuffle", "double_buffer",
           "multi_pass"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    # reference semantics: None becomes -1, and any explicit -1/None in the
    # shape disables batch-dim prepending
    shape = [-1 if s is None else s for s in shape]
    if append_batch_size and all(s >= 0 for s in shape):
        shape = [-1] + shape
    block = default_main_program().global_block()
    if lod_level > 0:
        # padded-dense sequence layout: [num_seqs, max_len, *feature] plus
        # an int32 lengths companion
        shape = [shape[0], -1] + shape[1:]
        block.create_var(
            name=name + "@SEQLEN", shape=[-1], dtype="int32",
            stop_gradient=True, is_data=True)
    main = block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    if lod_level > 0:
        main.seq_len_var = name + "@SEQLEN"
    return main


def _parallel_only(what):
    raise NotImplementedError(
        "fluid.layers.%s: the parameter-server markers come with the "
        "parallel runtime (ROADMAP A10)" % what)


class ListenAndServ(object):
    """The listen_and_serv server block (reference layers/io.py:108):
    ROADMAP A10."""

    def __init__(self, endpoint, inputs=None, fan_in=1, optimizer_mode=True):
        _parallel_only("ListenAndServ")


def Send(endpoints, send_vars, get_vars=None):
    """fluid.layers.Send (reference layers/io.py:179): ROADMAP A10."""
    _parallel_only("Send")


def Recv(endpoints, get_vars):
    """fluid.layers.Recv (reference layers/io.py:207): ROADMAP A10."""
    _parallel_only("Recv")


# ---------------------------------------------------------------------------
# in-graph file readers (reference: layers/io.py:262-366). Reader vars are
# persistable; their runtime state is a host-side reader object the
# Executor creates and pops in its io pre-pass (core/readers.py).
# ---------------------------------------------------------------------------

def _monkey_patch_reader_methods(reader_var):
    """reader.eof()/reader.reset() operate on the live reader in the
    current global scope (parity: monkey_patch_reader_methods, layers/
    io.py:235)."""
    from ..core.executor import global_scope

    def _state():
        state = global_scope().get(reader_var.name)
        if state is None:
            raise RuntimeError(
                "reader %r has no state; run the startup program first"
                % reader_var.name)
        return state

    reader_var.eof = lambda: _state().eof()
    reader_var.reset = lambda: _state().reset()
    reader_var.stop_gradient = True
    reader_var.persistable = True
    return reader_var


def _create_reader_var(op_type, inputs, attrs, shapes, dtypes, lod_levels):
    # the ragged-spec mistake is caught at BUILD time: read_file zips the
    # three lists, so a length mismatch would truncate reader fields
    if not (len(shapes) == len(dtypes) == len(lod_levels)):
        raise ValueError(
            "%s: shapes (%d), dtypes (%d) and lod_levels (%d) must "
            "describe the same number of reader fields"
            % (op_type, len(shapes), len(dtypes), len(lod_levels)))
    name = unique_name.generate(op_type)
    startup_blk = default_startup_program().current_block()
    startup_var = startup_blk.create_var(name=name, persistable=True,
                                         stop_gradient=True)
    startup_blk.append_op(type=op_type, inputs=inputs,
                          outputs={"Out": [startup_var]}, attrs=attrs,
                          infer_shape=False)
    main_blk = default_main_program().current_block()
    main_var = main_blk.create_var(name=name, persistable=True,
                                   stop_gradient=True)
    main_var.reader_shapes = list(shapes)
    main_var.reader_dtypes = list(dtypes)
    main_var.reader_lod_levels = list(lod_levels)
    return _monkey_patch_reader_methods(main_var)


def open_recordio_file(filename, shapes, lod_levels, dtypes):
    """Reader over one recordio file written by
    fluid.recordio_writer.convert_reader_to_recordio_file
    (reference: layers/io.py:262 + create_recordio_file_reader_op.cc)."""
    return _create_reader_var(
        "create_recordio_file_reader", None,
        {"filename": filename, "shapes": [list(s) for s in shapes],
         "lod_levels": list(lod_levels)},
        shapes, dtypes, lod_levels)


def open_files(filenames, thread_num, shapes, lod_levels, dtypes):
    """Reader over several recordio files scanned by thread_num host
    threads; record order across files is nondeterministic (reference:
    layers/io.py:291 + open_files_op.cc)."""
    return _create_reader_var(
        "open_files", None,
        {"file_names": list(filenames), "thread_num": int(thread_num),
         "shapes": [list(s) for s in shapes],
         "lod_levels": list(lod_levels)},
        shapes, dtypes, lod_levels)


def _decorated_reader(op_type, reader, attrs):
    return _create_reader_var(
        op_type, {"UnderlyingReader": [reader.name]}, attrs,
        getattr(reader, "reader_shapes", []),
        getattr(reader, "reader_dtypes", []),
        getattr(reader, "reader_lod_levels", []))


def create_shuffle_reader(reader, buffer_size, seed=0):
    return _decorated_reader("create_shuffle_reader", reader,
                             {"buffer_size": int(buffer_size), "seed": seed})


def create_double_buffer_reader(reader, place=None, capacity=2):
    """Stage the reader's records on the card ahead of the step (see
    core/readers.DoubleBufferReader). `place` (a Place or device string)
    pins the device; by default it is the running Executor's."""
    attrs = {"capacity": int(capacity)}
    if place is not None:
        attrs["__place__"] = place
    return _decorated_reader("create_double_buffer_reader", reader, attrs)


def create_multi_pass_reader(reader, pass_num):
    return _decorated_reader("create_multi_pass_reader", reader,
                             {"pass_num": int(pass_num)})


# later-fluid spellings of the same decorators
shuffle = create_shuffle_reader
double_buffer = create_double_buffer_reader
multi_pass = create_multi_pass_reader


def read_file(file_obj):
    """Pop one record from a reader: returns one Variable per reader field
    (reference: layers/io.py:353). Run by the Executor's io pre-pass: the
    popped arrays enter the step as feeds. Raises
    core.readers.EOFException at run time when exhausted; check
    reader.eof() first (the reference's `while not reader.eof()`)."""
    block = default_main_program().current_block()
    shapes = getattr(file_obj, "reader_shapes", None)
    if not shapes:
        raise ValueError("read_file needs a reader variable from "
                         "open_recordio_file/open_files or a decorator")
    dtypes = file_obj.reader_dtypes
    lod_levels = file_obj.reader_lod_levels
    outs = []
    for shape, dtype, lod in zip(shapes, dtypes, lod_levels):
        outs.append(block.create_var(
            name=unique_name.generate("read_file"),
            shape=[int(s) for s in list(shape)],  # shapes include batch dim
            dtype=dtype, lod_level=lod, stop_gradient=True, is_data=True))
    block.append_op(type="read", inputs={"Reader": [file_obj.name]},
                    outputs={"Out": outs}, infer_shape=False)
    return outs[0] if len(outs) == 1 else outs
