"""CUDA kernels for chain resolution, fleet and single-chain.

The counterparts of ``repro.kernels.chain_resolve.chain_resolve``'s
``resolve_vanilla_fleet_pallas`` and ``resolve_direct_fleet_pallas`` (the
stacked (T, C, P) fleet layout; both also read the words in place, as
strided views of the packed (T, C, P, 2) words), and
``resolve_vanilla_pallas`` and ``resolve_direct_pallas`` (one chain's
(C, N) planes), and beside them ``resolve_auto_batch_cuda``, the auto
resolve of a read's (T, B) pages in one launch on the packed words (no TPU
counterpart):
hand-written CUDA C++ in ``csrc/chain_resolve.cu``, built for Hopper by
``kernels._build``. The wrappers here take CUDA tensors only, check what
the kernel takes, allocate the outputs, launch on the current stream
without synchronising, and count the launch. ``ops`` dispatches CPU
tensors to the plain versions in ``ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stream_merge.stream_merge import planes_config


def _check_words(name: str, *tensors: torch.Tensor) -> None:
    for x in tensors:
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 words, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


#: T x P at or below which K1 walks a page with a warp (128 layers a
#: round, latency-bound pages: the decode state); above it, with a thread
#: (U layers' loads in flight, bandwidth-bound pages: a fleet read). Set by
#: chip_smoke.py's walk sweep (K1's row): the warp walk wins up to 16,384
#: pages, the thread walk from 65,536.
WARP_WALK_MAX_PAGES = 16_384
#: K1's walks: a thread a page, a warp a page (128 layers a round)
WALKS = {"thread": 0, "warp": 1}


def fleet_walk(t: int, p: int) -> str:
    """K1's walk for a (T, C, P) call, from the shape alone: no length is
    read, so choosing costs no sync."""
    return "warp" if t * p <= WARP_WALK_MAX_PAGES else "thread"


def word0_stride(w0: torch.Tensor, name: str = "resolve_vanilla_fleet") -> int:
    """Element stride of a (T, C, P) word plane K1 and K2 take: 1 for a
    contiguous plane, 2 for the ``l2[..., 0]`` (or ``l2[..., 1]``) view of
    contiguous (T, C, P, 2) words (strides (2CP, 2P, 2)). Strides of size-1
    axes are never used. Raises on any other layout."""
    t, c, p = w0.shape
    for es in (1, 2):
        want = (es * c * p, es * p, es)
        if all(n <= 1 or s == w for n, s, w in zip(w0.shape, w0.stride(), want)):
            return es
    raise ValueError(
        f"{name}: word strides {tuple(w0.stride())} are "
        f"neither a (T, C, P) plane's nor the l2[..., 0] view's")


def resolve_vanilla_fleet_cuda(w0: torch.Tensor, lengths: torch.Tensor, *,
                               walk: str | None = None):
    """Stacked first-hit chain walk: ``w0`` (T, C, P) int32 packed word0,
    a contiguous plane or the strided ``l2[..., 0]`` view of (T, C, P, 2)
    words (``word0_stride``), ``lengths`` (T,) int32. Returns ``(owner
    (T, P) int32 [-1 on a miss], hit (T, P) int32 — the owner's raw word0,
    0 on a miss)``. ``walk`` ("thread" or "warp") overrides
    ``fleet_walk``'s pick (for measurements)."""
    if w0.dim() != 3:
        raise ValueError("resolve_vanilla_fleet: word0 must be (T, C, P)")
    es = word0_stride(w0)
    if not w0.is_cuda:
        raise ValueError(f"resolve_vanilla_fleet: expected CUDA tensors, got {w0.device}")
    if w0.dtype != torch.int32:
        raise TypeError(f"resolve_vanilla_fleet: expected int32 words, got {w0.dtype}")
    _check_words("resolve_vanilla_fleet", lengths)
    t, c, p = w0.shape
    if lengths.shape != (t,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({t},)")
    owner = torch.empty((t, p), dtype=torch.int32, device=w0.device)
    hit = torch.empty((t, p), dtype=torch.int32, device=w0.device)
    if t * p == 0:
        return owner, hit
    lib = _build.library()
    code = lib.resolve_vanilla_fleet(
        w0.data_ptr(), lengths.data_ptr(), owner.data_ptr(), hit.data_ptr(),
        t, c, p, es, WALKS[walk or fleet_walk(t, p)],
        _build.launch_stream(w0))
    _build.check_launch("resolve_vanilla_fleet", code, pages=t * p)
    return owner, hit


def direct_fleet_stride(w0: torch.Tensor, w1: torch.Tensor) -> int:
    """Element stride of K2's inputs, from shapes, strides and ``data_ptr``
    alone. Two layouts are taken:

    - two contiguous (T, C, P) planes: 1;
    - ``l2[..., 0]`` and ``l2[..., 1]`` of contiguous (T, C, P, 2) words
      (the same strides, word1 4 bytes after word0, an 8-byte aligned base,
      so a page's entry is one 8-byte load): 2.

    Raises on anything else: views of two tensors, swapped words, a plane
    beside a view, a misaligned base."""
    name = "resolve_direct_fleet"
    if w0.dim() != 3 or w1.shape != w0.shape:
        raise ValueError(f"{name}: w0/w1 must both be (T, C, P)")
    es = word0_stride(w0, name)
    if word0_stride(w1, name) != es:
        raise ValueError(f"{name}: layout mixes a (T, C, P) plane with a "
                         "view of the packed words")
    if es == 2:
        a, b = w0.data_ptr(), w1.data_ptr()
        if w1.stride() != w0.stride() or b != a + 4:
            raise ValueError(f"{name}: layout is not l2[..., 0] and l2[..., 1] "
                             "of one (T, C, P, 2) tensor")
        if a % 8:
            raise ValueError(f"{name}: layout misaligned: the packed words "
                             "must start on an 8-byte boundary")
    return es


def resolve_direct_fleet_cuda(w0: torch.Tensor, w1: torch.Tensor,
                              lengths: torch.Tensor):
    """Stacked direct access of each tenant's active layer ``length - 1``
    (a length-0 tenant wraps to layer C-1, as the JAX reference does).
    ``w0``/``w1`` (T, C, P) int32 in one of ``direct_fleet_stride``'s two
    layouts, ``lengths`` (T,) int32. Returns ``(owner (T, P) int32, h0
    (T, P) int32, h1 (T, P) int32)``."""
    for x in (w0, w1):
        if x.dtype != torch.int32:
            raise TypeError(f"resolve_direct_fleet: expected int32 words, got {x.dtype}")
    es = direct_fleet_stride(w0, w1)
    for x in (w0, w1):
        if not x.is_cuda:
            raise ValueError(f"resolve_direct_fleet: expected CUDA tensors, got {x.device}")
    _check_words("resolve_direct_fleet", lengths)
    t, c, p = w0.shape
    if lengths.shape != (t,):
        raise ValueError(f"resolve_direct_fleet: lengths shape "
                         f"{tuple(lengths.shape)} != ({t},)")
    owner, h0, h1 = (torch.empty((t, p), dtype=torch.int32, device=w0.device)
                     for _ in range(3))
    if t * p == 0:
        return owner, h0, h1
    lib = _build.library()
    code = lib.resolve_direct_fleet(
        w0.data_ptr(), w1.data_ptr(), lengths.data_ptr(), owner.data_ptr(),
        h0.data_ptr(), h1.data_ptr(), t, c, p, es,
        _build.launch_stream(w0))
    _build.check_launch("resolve_direct_fleet", code, pages=t * p)
    return owner, h0, h1


#: The launch counter of the batch entry: its kernels carry K1's name
#: (``vanilla_fleet_kernel``), so a trace and ``_build.LAUNCHES`` count
#: them as K1's; ``AUTO_BATCH_ENTRY`` counts them apart besides.
AUTO_BATCH_COUNTER = "resolve_vanilla_fleet"
AUTO_BATCH_ENTRY = "resolve_auto_batch"


def resolve_auto_batch_cuda(l2: torch.Tensor, lengths: torch.Tensor,
                            page_ids: torch.Tensor, *, walk: str | None = None):
    """The auto resolve of a read's pages: for each (t, b) of ``page_ids``
    (T, B) int32, the active entry of page ``page_ids[t, b]`` where it is
    ALLOCATED and BFI_VALID, else the first-hit walk of tenant t's chain.
    ``l2`` is the packed (T, C, P, 2) int32 words, contiguous and 8-byte
    aligned (a one-tenant slice ``l2[t:t + 1]`` is too): the kernel reads
    them in place from their base, so no ``l2[..., k]`` view is made.
    ``lengths`` (T,) int32; ``page_ids`` is read in place at its strides
    (an expanded row too). Ids lie in [0, P): on any other the kernel
    traps, so the stream's next sync raises, as the plain version raises
    at once. Returns ``(owner, ptr, found, zero, lookups, cold)``, each
    (T, B), bit for bit ``ref.resolve_auto_batch_ref`` on ``l2[..., 0]``
    and ``l2[..., 1]``: owner/ptr/lookups int32, found/zero/cold bool, the
    planes of two output buffers. ``walk`` ("thread" or "warp") overrides
    ``fleet_walk(T, B)`` (for measurements). One launch, counted as one of
    K1's with T × B pages, and as one of ``AUTO_BATCH_ENTRY``'s."""
    name = AUTO_BATCH_ENTRY
    if l2.dim() != 4 or l2.shape[3] != 2:
        raise ValueError(f"{name}: words must be (T, C, P, 2), got {tuple(l2.shape)}")
    if l2.dtype != torch.int32 or page_ids.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words and ids, got "
                        f"{l2.dtype} and {page_ids.dtype}")
    if not l2.is_contiguous():
        raise ValueError(f"{name}: layout is not contiguous (T, C, P, 2) words")
    if l2.data_ptr() % 8:
        raise ValueError(f"{name}: layout misaligned: the packed words must "
                         "start on an 8-byte boundary")
    if page_ids.dim() != 2:
        raise ValueError(f"{name}: page ids must be (T, B)")
    for x in (l2, page_ids):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
    _check_words(name, lengths)
    t, c, p, _ = l2.shape
    b = page_ids.shape[1]
    if lengths.shape != (t,) or page_ids.shape[0] != t:
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} and ids "
                         f"{tuple(page_ids.shape)} must have the words' {t} tenants")
    words = torch.empty((3, t, b), dtype=torch.int32, device=l2.device)
    flags = torch.empty((3, t, b), dtype=torch.bool, device=l2.device)
    if t * b:
        if not c * p:
            raise ValueError(f"{name}: the words hold no entry to read")
        code = _build.library().resolve_auto_batch(
            l2.data_ptr(), lengths.data_ptr(), page_ids.data_ptr(),
            *page_ids.stride(), words.data_ptr(), flags.data_ptr(), t, c, p, b,
            WALKS[walk or fleet_walk(t, b)], _build.launch_stream(l2))
        _build.check_launch(AUTO_BATCH_COUNTER, code, pages=t * b,
                            entry=AUTO_BATCH_ENTRY)
    owner, ptr, lookups = words.unbind()
    found, zero, cold = flags.unbind()
    return owner, ptr, found, zero, lookups, cold


def _check_planes(name: str, alloc: torch.Tensor, *words: torch.Tensor) -> int:
    """Check one chain's planes; return the allocation map's entry bytes."""
    _check_words(name, *words)
    if not alloc.is_cuda or not alloc.is_contiguous():
        raise ValueError(f"{name}: alloc must be a contiguous CUDA tensor")
    if alloc.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"{name}: alloc must be bool or int32, got {alloc.dtype}")
    if any(w.shape != alloc.shape for w in words):
        raise ValueError(f"{name}: every plane must have the alloc's shape")
    return alloc.element_size()


#: The 4-byte registers of loads a K6 thread holds in a batch, fixed in
#: ``csrc/chain_resolve.cu`` (``kVanillaLoadWords``): a batch is this many
#: words over the words of one layer's load.
VANILLA_LOAD_WORDS = 32


def vanilla_config(alloc: torch.Tensor) -> tuple[int, int]:
    """``(pages a thread, layers a batch)`` of K6 for a (C, N) allocation
    map. The pages a thread are K9's planes pick (``planes_config``): 4
    where 4 divides N and the map is aligned to 4 entries' bytes, else 1.
    The layers a batch follow: 8 for 4 int32 pages, else 32."""
    v = planes_config(alloc)[0]
    return v, VANILLA_LOAD_WORDS // max(1, v * alloc.element_size() // 4)


def resolve_vanilla_cuda(alloc: torch.Tensor, ptrs: torch.Tensor, length):
    """Single-chain first-hit walk: ``alloc`` (C, N) bool or int32 (tested
    ``!= 0``), ``ptrs`` (C, N) int32, ``length`` an int or a 0-d tensor
    (it may exceed C; layers >= C do not exist). Returns ``(owner (N,)
    int32 [-1 on a miss], ptr (N,) int32 [0 on a miss])``. The pages a
    thread come from ``vanilla_config``."""
    nbytes = _check_planes("resolve_vanilla", alloc, ptrs)
    if alloc.dim() != 2:
        raise ValueError("resolve_vanilla: alloc/ptrs must be (C, N)")
    c, n = alloc.shape
    # the length stays on the device: no sync for a 0-d CUDA tensor
    ln = torch.as_tensor(length, device=alloc.device).to(torch.int32).reshape(1)
    owner = torch.empty((n,), dtype=torch.int32, device=alloc.device)
    ptr = torch.empty((n,), dtype=torch.int32, device=alloc.device)
    if n == 0:
        return owner, ptr
    vec, _ = vanilla_config(alloc)
    code = _build.library().resolve_vanilla(
        alloc.data_ptr(), ptrs.data_ptr(), ln.data_ptr(), owner.data_ptr(),
        ptr.data_ptr(), c, n, nbytes, vec,
        _build.launch_stream(alloc))
    _build.check_launch("resolve_vanilla", code)
    return owner, ptr


def resolve_direct_cuda(alloc_active: torch.Tensor, bfi_active: torch.Tensor,
                        ptrs_active: torch.Tensor):
    """Single-chain direct lookup of the active layer: all inputs (N,);
    ``alloc_active`` bool or int32, the others int32. ``owner`` is the bfi
    where allocated, else -1; ``ptr`` the pointer where allocated, else 0.
    BFI_VALID is the caller's business, as in the JAX kernel."""
    nbytes = _check_planes("resolve_direct", alloc_active, bfi_active,
                           ptrs_active)
    if alloc_active.dim() != 1:
        raise ValueError("resolve_direct: inputs must be (N,)")
    n = alloc_active.shape[0]
    owner = torch.empty((n,), dtype=torch.int32, device=alloc_active.device)
    ptr = torch.empty((n,), dtype=torch.int32, device=alloc_active.device)
    if n == 0:
        return owner, ptr
    code = _build.library().resolve_direct(
        alloc_active.data_ptr(), bfi_active.data_ptr(), ptrs_active.data_ptr(),
        owner.data_ptr(), ptr.data_ptr(), n, nbytes,
        _build.launch_stream(alloc_active))
    _build.check_launch("resolve_direct", code)
    return owner, ptr
