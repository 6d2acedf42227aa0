"""Kernels built from another copy of a `csrc/` source, for the design
experiments of `exp_scan` and the tools' `--source` options.

A `Variant` compiles its text under build/kernels/variants/ with the base
kernel's C entry point and flags; `swapped` puts it in the base kernel's
place in `_kernels` for the duration of a `with`, so the package's own
wrappers launch it. Variants are not in `_kernels.KERNELS`, so their
launches count nowhere.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
from pathlib import Path

from .. import _kernels


class Variant(_kernels.Kernel):
    def __init__(self, base: _kernels.Kernel, text: str):
        super().__init__(base.name, base.argtypes, base.extra_flags,
                         base.entries)
        self.text = text

    @property
    def source(self) -> Path:
        tag = hashlib.sha256(self.text.encode()).hexdigest()[:16]
        path = _kernels.BUILD_DIR / "variants" / tag / f"{self.name}.cu"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(self.text)
        return path


@contextlib.contextmanager
def swapped(attr: str, kernel: _kernels.Kernel):
    """Launch `kernel` wherever the package launches `_kernels.<attr>`."""
    saved = getattr(_kernels, attr)
    setattr(_kernels, attr, kernel)
    try:
        yield kernel
    finally:
        setattr(_kernels, attr, saved)


def candidates(base: _kernels.Kernel, sources, edit=None
               ) -> list[tuple[str, _kernels.Kernel]]:
    """[("package", base)] and a Variant of `base` per source path (its
    text passed through `edit` where given), all built at once (one nvcc
    each)."""
    cands = [("package", base)]
    cands += [(str(src), Variant(base, (edit or str)(Path(src).read_text())))
              for src in sources]
    with concurrent.futures.ThreadPoolExecutor(len(cands)) as pool:
        for fut in [pool.submit(k.build) for _, k in cands]:
            fut.result()
    return cands
