"""Paged DRAM allocator with Def.-1 logical addressing (paper §2.2).

The allocator reproduces the TVM allocation discipline the paper adopts as
its reference:

* the DRAM region assigned to the VTA starts at ``offset``;
* memory is managed in 4 KiB pages;
* **every** allocation advances the pointer to the start of the next page —
  even when the current page is untouched (Fig. 2: the very first 256-byte
  allocation lands on page 1, not page 0);
* allocations are physically contiguous;
* ``log_addr = (phy_addr - offset) // (precision × nb_elem)``  (Def. 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Region:
    """One allocated DRAM region holding ``count`` structures of
    ``struct_bytes`` each (= precision × nb_elem of Def. 1)."""

    name: str
    kind: str              # inp | wgt | acc | out | uop | insn
    phys_addr: int
    struct_bytes: int
    count: int

    @property
    def nbytes(self) -> int:
        return self.struct_bytes * self.count

    @property
    def end(self) -> int:
        return self.phys_addr + self.nbytes

    def logical_addr(self, offset: int = 0) -> int:
        """Def. 1: logical address of the first structure in the region."""
        return (self.phys_addr - offset) // self.struct_bytes

    def logical_of(self, index: int, offset: int = 0) -> int:
        if not 0 <= index < self.count:
            raise IndexError(f"structure {index} out of range for {self.name}")
        return self.logical_addr(offset) + index


class DramAllocator:
    """Fresh-page bump allocator (paper §2.2 / Fig. 2)."""

    def __init__(self, offset: int = 0, page_bytes: int = 4096):
        if page_bytes <= 0 or page_bytes & (page_bytes - 1):
            raise ValueError("page_bytes must be a positive power of two")
        self.offset = offset
        self.page_bytes = page_bytes
        self._ptr = offset          # next unexamined byte
        self.regions: List[Region] = []
        self._by_name: Dict[str, Region] = {}

    def _next_page(self, addr: int) -> int:
        """Start of the page strictly after ``addr``'s page.

        Fig. 2 semantics: the pointer always advances to the *next* page
        boundary before allocating, even if ``addr`` is already aligned.
        """
        rel = addr - self.offset
        return self.offset + (rel // self.page_bytes + 1) * self.page_bytes

    def alloc(self, name: str, kind: str, struct_bytes: int, count: int) -> Region:
        if count < 0 or struct_bytes <= 0:
            raise ValueError("bad allocation request")
        if name in self._by_name:
            raise ValueError(f"duplicate region name {name!r}")
        addr = self._next_page(self._ptr)
        # Def.-1 exactness: logical addresses are ⌊(phy−offset)/struct⌋, so
        # the region start must be struct-aligned (relative to the offset).
        # For the paper's profile every struct size divides the 4 KiB page
        # and this is a no-op; the TPU profile's 16 KiB WGT blocks exceed a
        # page and need the extra alignment (DESIGN.md §2).
        rel = addr - self.offset
        if rel % struct_bytes:
            rel = (rel // struct_bytes + 1) * struct_bytes
            addr = self.offset + rel
        region = Region(name=name, kind=kind, phys_addr=addr,
                        struct_bytes=struct_bytes, count=count)
        self._ptr = addr + region.nbytes
        self.regions.append(region)
        self._by_name[name] = region
        return region

    def __getitem__(self, name: str) -> Region:
        return self._by_name[name]

    def get(self, name: str) -> Optional[Region]:
        return self._by_name.get(name)

    @property
    def total_bytes(self) -> int:
        """Bytes from the offset through the end of the last region."""
        return self._ptr - self.offset

    def image_size(self) -> int:
        """Size of a DRAM image that covers every region (page-rounded)."""
        pages = (self.total_bytes + self.page_bytes - 1) // self.page_bytes
        return max(1, pages) * self.page_bytes
