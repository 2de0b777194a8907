"""Algorithm / Tool base contracts.

Ports of the reference's uniform algorithm surface (tools/misc/impl/
Algorithm.hpp:8-120 and Tool.hpp:79-251): an Algorithm owns input/output
Properties and a TimeInfo; ``run()`` wraps ``execute()`` and stamps
``exec_time`` into the info — exactly what Graph.cpp:238-262's
executeAlgorithm wrapper does around every build stage.
"""

from __future__ import annotations

import time

from .properties import Properties
from .time_info import TimeInfo


class Algorithm:
    """execute()/get_info()/TimeInfo contract (Algorithm.hpp)."""

    def __init__(self, name: str, props: dict | None = None):
        self.name = name
        self.input = dict(props or {})
        self.info: dict = {"name": name}
        self.time_info = TimeInfo()

    def execute(self, *args, **kw):  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self, *args, **kw):
        """executeAlgorithm wrapper (Graph.cpp:242-262): times execute()
        and merges the stopwatch tree into the output info."""
        t0 = time.time()
        with self.time_info.section("execute"):
            result = self.execute(*args, **kw)
        self.info["exec_time"] = round(time.time() - t0, 3)
        self.info.update(self.time_info.get_properties("time"))
        return result

    def get_info(self) -> dict:
        return dict(self.info)

    def get_properties(self) -> Properties:
        props = Properties()
        props.add(0, self.name)
        props.update(self.get_info(), depth=1)
        return props


class Tool(Algorithm):
    """CLI tool base (Tool.hpp:79-251): parse args -> run -> dump info."""

    def __init__(self, name: str):
        super().__init__(name)
        self.parser = self.build_parser()

    def build_parser(self):  # pragma: no cover - abstract
        import argparse

        return argparse.ArgumentParser(prog=self.name)

    def main(self, argv=None) -> int:
        args = self.parser.parse_args(argv)
        self.input.update(vars(args))
        self.run()
        if self.input.get("verbose", 1):
            print(self.get_properties().dump_raw())
        return 0
