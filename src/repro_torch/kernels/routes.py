"""Launch counts per route, shared by the kernel wrappers that have more
than one route (the GEMMs and attention: tensor cores or CUDA-core FMAs,
chosen by dtype; RMSNorm: 16-byte vectors or one element a lane, chosen
by shape and alignment)."""

from __future__ import annotations

import functools


class RouteCounted:
    """A kernel wrapper that counts its launches per route, in
    ``launches_<route>`` for each of ``routes`` (by default ``tc`` and
    ``fma``).  ``launches``, the count every kernel wrapper of the port
    has, is their sum; setting it to 0 resets them all."""

    def __init__(self, fn, routes=("tc", "fma")):
        functools.update_wrapper(self, fn)
        self.routes = tuple(routes)
        for route in self.routes:
            setattr(self, f"launches_{route}", 0)

    @classmethod
    def over(cls, *routes):
        """A decorator counting over the given routes."""
        return lambda fn: cls(fn, routes)

    def __call__(self, *args, **kw):
        return self.__wrapped__(*args, **kw)

    def by_route(self) -> dict[str, int]:
        return {route: getattr(self, f"launches_{route}")
                for route in self.routes}

    @property
    def launches(self) -> int:
        return sum(self.by_route().values())

    @launches.setter
    def launches(self, value: int) -> None:
        if value:
            raise ValueError(f"a launch count is reset to 0, not {value}")
        for route in self.routes:
            setattr(self, f"launches_{route}", 0)

    def count(self, plan) -> None:
        route = plan["route"]
        if route not in self.routes:
            raise ValueError(f"route {route!r} is none of {self.routes}")
        name = f"launches_{route}"
        setattr(self, name, getattr(self, name) + 1)
