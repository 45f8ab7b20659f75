"""Launch counts per route, shared by the kernel wrappers that have two
routes (tensor cores or CUDA-core FMAs, chosen by dtype)."""

from __future__ import annotations

import functools


class RouteCounted:
    """A kernel wrapper that counts its launches per route, in
    ``launches_tc`` and ``launches_fma``.  ``launches``, the count every
    kernel wrapper of the port has, is their sum; setting it to 0 resets
    both."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self.launches_tc = self.launches_fma = 0

    def __call__(self, *args, **kw):
        return self.__wrapped__(*args, **kw)

    @property
    def launches(self) -> int:
        return self.launches_tc + self.launches_fma

    @launches.setter
    def launches(self, value: int) -> None:
        if value:
            raise ValueError(f"a launch count is reset to 0, not {value}")
        self.launches_tc = self.launches_fma = 0

    def count(self, plan) -> None:
        if plan["route"] == "tc":
            self.launches_tc += 1
        else:
            self.launches_fma += 1
