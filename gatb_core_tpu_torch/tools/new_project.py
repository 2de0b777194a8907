"""new_project: generate a tool-project skeleton using gatb_core_tpu_torch.

Port of gatb_core_tpu/tools/new_project.py: the same tree and the same
text, with the package name gatb_core_tpu_torch where the JAX package
writes gatb_core_tpu.

Reference: scripts/NewProject/NewProject.sh (+ XXX.cpp/XXX.hpp/main.cpp
templates) — generates a CMake project linking gatb-core with a Tool
subclass whose ``execute()`` receives parsed options. The TPU-native
equivalent emits a Python package with a Tool subclass wired to the same
option-parser conventions (misc/enums STR_* flag spellings), a CLI main,
and a pytest smoke test.

Usage:  python -m gatb_core_tpu_torch.tools.new_project -d DIR -n NAME [-t N]
        (same flags as the reference script: -d install dir, -n tool name,
         -t number of tools in the project)
"""

from __future__ import annotations

import argparse
import os
import sys

_TOOL_PY = '''"""{name}: a tool built on gatb_core_tpu_torch."""

from gatb_core_tpu_torch.misc.properties import Properties
from gatb_core_tpu_torch.kmer.counting import count_kmers


class {cls}:
    """Tool skeleton (reference scripts/NewProject/XXX.hpp template:
    a misc::impl::Tool subclass with an OptionsParser and execute())."""

    name = "{name}"

    def __init__(self):
        self.parser = self.get_options_parser()

    @staticmethod
    def get_options_parser():
        import argparse

        p = argparse.ArgumentParser(prog="{name}")
        # reference flag spellings (misc/api/StringsRepository.hpp)
        p.add_argument("-in", dest="input", required=True,
                       help="input bank (FASTA/FASTQ[.gz], album, list)")
        p.add_argument("-kmer-size", dest="kmer_size", type=int, default=31)
        p.add_argument("-abundance-min", dest="abundance_min", default=2)
        p.add_argument("-verbose", dest="verbose", type=int, default=1)
        return p

    def execute(self, args) -> Properties:
        """Replace with the tool's work; returns the info properties the
        way every reference Algorithm does (getInfo())."""
        res = count_kmers(args.input, kmer_size=args.kmer_size,
                          abundance_min=args.abundance_min)
        info = Properties()
        for key, value in res.info.items():
            info.add(1, key, value)
        if args.verbose:
            print(info.dump_raw())
        return info

    def run(self, argv=None):
        return self.execute(self.parser.parse_args(argv))


def main(argv=None):
    {cls}().run(argv)


if __name__ == "__main__":
    main()
'''

_TEST_PY = '''from {pkg}.{mod} import {cls}


def test_{mod}_parser_defaults():
    p = {cls}.get_options_parser()
    args = p.parse_args(["-in", "x.fa"])
    assert args.kmer_size == 31 and args.abundance_min == 2
'''

_README = """# {name}

Generated by `gatb_core_tpu_torch.tools.new_project` (the TPU-native analogue of
GATB-core's scripts/NewProject/NewProject.sh).

Run a tool:

    python -m {pkg}.{mod} -in reads.fasta -kmer-size 31

Test:

    python -m pytest tests/
"""


def _camel(name: str) -> str:
    return "".join(part.capitalize() or "_" for part in
                   name.replace("-", "_").split("_"))


def create_project(directory: str, name: str, nb_tools: int = 1) -> str:
    """Create the project skeleton; returns the project path."""
    project = os.path.join(directory, name)
    if os.path.exists(project):
        raise FileExistsError(f"{project} already exists")
    pkg = name.replace("-", "_").lower()
    os.makedirs(os.path.join(project, pkg))
    os.makedirs(os.path.join(project, "tests"))
    tool_names = [name] if nb_tools == 1 else \
        [f"{name}_{i + 1}" for i in range(nb_tools)]
    with open(os.path.join(project, pkg, "__init__.py"), "w") as f:
        f.write("")
    first_mod = None
    for tool in tool_names:
        mod = tool.replace("-", "_").lower()
        first_mod = first_mod or mod
        cls = _camel(tool)
        with open(os.path.join(project, pkg, f"{mod}.py"), "w") as f:
            f.write(_TOOL_PY.format(name=tool, cls=cls))
        with open(os.path.join(project, "tests", f"test_{mod}.py"),
                  "w") as f:
            f.write(_TEST_PY.format(pkg=pkg, mod=mod, cls=cls))
    with open(os.path.join(project, "README.md"), "w") as f:
        f.write(_README.format(name=name, pkg=pkg, mod=first_mod))
    return project


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="new_project",
        description="create a new tool project using gatb_core_tpu_torch "
                    "(NewProject.sh equivalent)")
    p.add_argument("-d", dest="directory", required=True,
                   help="directory in which the project is created")
    p.add_argument("-n", dest="name", required=True, help="project name")
    p.add_argument("-t", dest="nb_tools", type=int, default=1,
                   help="number of tools in the project (default 1)")
    args = p.parse_args(argv)
    path = create_project(args.directory, args.name, args.nb_tools)
    print(f"created {path}")
    return path


if __name__ == "__main__":
    main()
