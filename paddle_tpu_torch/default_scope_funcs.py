"""A thread-local stack of scopes (parity:
python/paddle/fluid/default_scope_funcs.py and the JAX package's
default_scope_funcs.py).

The top of the stack is the current scope, its bottom the global scope.
`var` / `find_var` act on the current scope (`find_var` searches its
parents too); `scoped_function` runs a callable inside a fresh kid scope
that is dropped afterwards.
"""
import threading

from .core.executor import global_scope

__tl_scope__ = threading.local()

__all__ = ["get_cur_scope", "enter_local_scope", "leave_local_scope", "var",
           "find_var", "scoped_function"]


def get_cur_scope():
    """The current scope (the global scope when nothing was entered)."""
    stack = getattr(__tl_scope__, "cur_scope", None)
    if stack is None:
        stack = __tl_scope__.cur_scope = []
    if not stack:
        stack.append(global_scope())
    return stack[-1]


def enter_local_scope():
    """Push a new kid of the current scope."""
    cur = get_cur_scope()
    __tl_scope__.cur_scope.append(cur.new_scope())


def leave_local_scope():
    """Pop the current scope and drop its parent's kids."""
    __tl_scope__.cur_scope.pop()
    get_cur_scope().drop_kids()


def var(name):
    """Create (or get) a variable in the current scope."""
    return get_cur_scope().var(name)


def find_var(name):
    """Find a variable in the current scope or its parents."""
    return get_cur_scope().find_var(name)


def scoped_function(func):
    """Call `func` inside a fresh local scope."""
    enter_local_scope()
    try:
        func()
    finally:
        leave_local_scope()
