"""Unique name generator.

Parity: python/paddle/fluid/unique_name.py (reference).
"""
import contextlib
from collections import defaultdict


class UniqueNameGenerator(object):
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    yield
    switch(old)
