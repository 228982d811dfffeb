"""A copy of the benchmark with a toy cell added as new files and new
entries only (``toy_files/``): the way a later cell is added, and the
test bed of the ranks of a cell on more than one chip.

    python3 gpubench/tests/toycell.py DEST

copies ``gpubench/`` and ``BENCHMARK.json`` into DEST and adds the toy
cells ``toy.one`` (one chip) and ``toy.four`` (four).  The copy holds no
``src/``: put the repository's ``src`` on ``PYTHONPATH`` to run it.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FILES = pathlib.Path(__file__).resolve().parent / "toy_files"
ENTRIES = "benchmark.json"


def make_copy(dest) -> pathlib.Path:
    """The copy at ``dest``: this checkout's benchmark with the toy cell's
    files added (none replaces a file) and its entries appended."""
    dest = pathlib.Path(dest)
    shutil.copytree(ROOT / "gpubench", dest / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in sorted(FILES.rglob("*")):
        rel = src.relative_to(FILES)
        if src.is_dir() or rel.name == ENTRIES or "__pycache__" in rel.parts:
            continue
        to = dest / "gpubench" / rel
        if to.exists():
            raise FileExistsError(f"the toy cell would replace {to}")
        to.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, to)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in json.loads((FILES / ENTRIES).read_text()).items():
        bench[key] = bench[key] + entries
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")
    return dest


if __name__ == "__main__":
    print(make_copy(sys.argv[1]))
