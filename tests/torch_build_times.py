"""Time the kernel library's build (one ``nvcc`` a source, all in
parallel, then the link) for two source trees in turns: the first tree,
the second, the second, the first, each into a fresh directory.

    python tests/torch_build_times.py PARENT/src src

Each argument is a directory holding ``repro_torch``.  Needs ``nvcc``
(the card's machine).  Prints each build's wall seconds and a JSON line
of them by tree.
"""
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path


def build_seconds(root: Path) -> float:
    """Wall seconds of ``repro_torch.kernels._build.build()`` from the
    sources under ``root``, into a fresh build directory."""
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    tmp = Path(tempfile.mkdtemp(prefix="build_times_"))
    try:
        b = importlib.import_module("repro_torch.kernels._build")
        b.BUILD_ROOT = tmp
        t0 = time.perf_counter()
        if not b.build().built:
            raise RuntimeError("the library was not built anew")
        return time.perf_counter() - t0
    finally:
        sys.path.remove(str(root))
        shutil.rmtree(tmp, ignore_errors=True)


def main(first: str, second: str) -> None:
    roots = {"first": Path(first).resolve(), "second": Path(second).resolve()}
    out = {"first": [], "second": []}
    for who in ("first", "second", "second", "first"):
        s = build_seconds(roots[who])
        out[who].append(s)
        print(who, roots[who], s, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:3])
