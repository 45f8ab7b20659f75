"""Trace eDSL: assemble RVV-lite vector programs as instruction traces.

A kernel is written once against :class:`Assembler` and yields a
:class:`Program` — dense numpy field arrays consumed by

  * ``core.interpreter``  — functional execution (numeric oracle), and
  * ``core.simulator``    — the cycle-level cVRF / Register Dispersion model.

Hot loops are emitted with :meth:`Assembler.repeat`, which replicates an
instruction block with per-instruction address strides in vectorised numpy
(multi-million-instruction traces assemble in milliseconds, matching how a
compiler emits a strip-mined RVV loop body that reuses the same register
names every iteration).

Every ``repeat`` additionally records *periodicity metadata* on the finished
:class:`Program` (``repeats``: one ``(start, block_len, count)`` triple per
expanded repeat block, including copies replicated by enclosing repeats).
``core.folding`` uses this to simulate only a warm-up plus two measured
periods of each hot loop and extrapolate the cycle counters algebraically —
exact for steady-state traces, replacing lossy prefix truncation.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.core import isa

_FIELDS = ("op", "vd", "vs1", "vs2", "addr", "imm", "cost_override")


@dataclasses.dataclass
class Program:
    """A finalized RVV-lite trace plus its memory image."""

    op: np.ndarray            # (T,) int32 opcode
    vd: np.ndarray            # (T,) int32 destination vreg (-1 if none)
    vs1: np.ndarray           # (T,) int32 source 1 (-1 if none)
    vs2: np.ndarray           # (T,) int32 source 2 (-1 if none)
    addr: np.ndarray          # (T,) int64 byte address for memory ops (-1 else)
    imm: np.ndarray           # (T,) float32 scalar immediate
    cost_override: np.ndarray  # (T,) int32, -1 => use the ISA table cost
    memory: np.ndarray        # (M,) float32 initial memory image
    buffers: dict[str, tuple[int, int]]  # name -> (base byte addr, n_f32)
    name: str = "program"
    # Periodicity metadata: (start_row, block_len, count) per expanded
    # ``Assembler.repeat`` block (properly nested or disjoint by construction).
    repeats: list[tuple[int, int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def num_instructions(self) -> int:
        return int(self.op.shape[0])

    def active_vregs(self) -> np.ndarray:
        """Distinct architectural vector registers referenced by the trace."""
        tbl = isa.op_table()
        used = np.concatenate([
            self.vd[tbl["writes_vd"][self.op] | tbl["reads_vd"][self.op]],
            self.vs1[tbl["reads_vs1"][self.op]],
            self.vs2[tbl["reads_vs2"][self.op]],
        ])
        used = used[used >= 0]
        mask_writers = tbl["writes_mask"][self.op]
        out = np.unique(used)
        if mask_writers.any() or np.isin(self.op, list(isa.MASK_READERS)).any():
            out = np.unique(np.concatenate([out, [isa.MASK_REG]]))
        return out

    def vrf_utilization(self) -> float:
        return float(len(self.active_vregs())) / isa.NUM_ARCH_VREGS

    def buffer_view(self, memory: np.ndarray, name: str) -> np.ndarray:
        base, n = self.buffers[name]
        assert base % 4 == 0
        return memory[base // 4: base // 4 + n]


class MemoryMap:
    """32-byte-aligned named buffer allocator building the initial memory."""

    def __init__(self):
        self._cursor = 0
        self._chunks: list[tuple[int, np.ndarray]] = []
        self.buffers: dict[str, tuple[int, int]] = {}

    @staticmethod
    def _align(x: int, a: int = isa.VLEN_BYTES) -> int:
        return (x + a - 1) // a * a

    def alloc(self, name: str, data_or_size) -> int:
        """Allocate a named f32 buffer; returns its base *byte* address."""
        if isinstance(data_or_size, (int, np.integer)):
            data = np.zeros(int(data_or_size), np.float32)
        else:
            data = np.asarray(data_or_size, np.float32).reshape(-1)
        base = self._align(self._cursor)
        self._cursor = base + data.size * 4
        self._chunks.append((base, data))
        self.buffers[name] = (base, data.size)
        return base

    def build(self, extra_bytes: int = 0) -> np.ndarray:
        size = self._align(self._cursor + extra_bytes) // 4
        mem = np.zeros(size, np.float32)
        for base, data in self._chunks:
            mem[base // 4: base // 4 + data.size] = data
        return mem


class Assembler:
    """Builds instruction traces. Registers are plain ints in [0, 32)."""

    def __init__(self, name: str = "program"):
        self.name = name
        self._cols = {f: [] for f in _FIELDS}
        # Per-level address strides: _strides[k] is the stride applied by the
        # (k+1)-th enclosing ``repeat``; one list per level, aligned with the
        # instruction columns.  Levels are created lazily, so nests of any
        # depth (batched conv, multi-head attention) cost nothing shallower
        # kernels.
        self._strides: list[list[int]] = []
        self._segs: list[tuple[int, int, int]] = []   # (start, block_len, n)

    def _set_strides(self, strides) -> None:
        n = len(self._cols["op"]) - 1          # the instruction just emitted
        while len(self._strides) < len(strides):
            self._strides.append([0] * n)
        for lv, col in enumerate(self._strides):
            col.append(int(strides[lv]) if lv < len(strides) else 0)

    @staticmethod
    def _stride_vec(strides, stride, stride2, stride3):
        if strides is not None:
            if stride or stride2 or stride3:
                raise ValueError("pass either strides= or stride/stride2/"
                                 "stride3, not both")
            return tuple(int(s) for s in strides)
        return (stride, stride2, stride3)

    # ---------------------------------------------------------------- emit --
    def _emit(self, op, vd=-1, vs1=-1, vs2=-1, addr=-1, imm=0.0,
              cost=-1, strides=()):
        for r in (vd, vs1, vs2):
            if r != -1 and not (0 <= r < isa.NUM_ARCH_VREGS):
                raise ValueError(f"bad vreg {r}")
        c = self._cols
        c["op"].append(op); c["vd"].append(vd); c["vs1"].append(vs1)
        c["vs2"].append(vs2); c["addr"].append(addr); c["imm"].append(imm)
        c["cost_override"].append(cost)
        self._set_strides(strides)

    # Memory ops.  The per-level stride vector ``strides`` advances ``addr``
    # by ``strides[k]`` per iteration of the (k+1)-th enclosing ``repeat``;
    # the legacy ``stride``/``stride2``/``stride3`` keywords spell the first
    # three levels.
    def vle(self, vd, addr, stride=0, stride2=0, stride3=0, *, strides=None):
        self._emit(isa.VLE, vd=vd, addr=addr,
                   strides=self._stride_vec(strides, stride, stride2,
                                            stride3))

    def vse(self, vs, addr, stride=0, stride2=0, stride3=0, *, strides=None):
        self._emit(isa.VSE, vs1=vs, addr=addr,
                   strides=self._stride_vec(strides, stride, stride2,
                                            stride3))

    def vbcast(self, vd, addr, stride=0, stride2=0, stride3=0, *,
               strides=None):
        self._emit(isa.VBCAST, vd=vd, addr=addr,
                   strides=self._stride_vec(strides, stride, stride2,
                                            stride3))

    def vses(self, vs, addr, stride=0, stride2=0, stride3=0, *,
             strides=None):
        """Store element 0 of vs as a 4-byte scalar (vfmv.f.s + fsw)."""
        self._emit(isa.VSES, vs1=vs, addr=addr,
                   strides=self._stride_vec(strides, stride, stride2,
                                            stride3))

    # Arithmetic.
    def vadd(self, vd, vs1, vs2): self._emit(isa.VADD, vd, vs1, vs2)
    def vsub(self, vd, vs1, vs2): self._emit(isa.VSUB, vd, vs1, vs2)
    def vmul(self, vd, vs1, vs2): self._emit(isa.VMUL, vd, vs1, vs2)
    def vdiv(self, vd, vs1, vs2): self._emit(isa.VDIV, vd, vs1, vs2)
    def vsqrt(self, vd, vs1): self._emit(isa.VSQRT, vd, vs1)
    def vmacc(self, vd, vs1, vs2): self._emit(isa.VFMA, vd, vs1, vs2)
    def vmax(self, vd, vs1, vs2): self._emit(isa.VMAX, vd, vs1, vs2)
    def vmin(self, vd, vs1, vs2): self._emit(isa.VMIN, vd, vs1, vs2)
    def vxor(self, vd, vs1, vs2): self._emit(isa.VXOR, vd, vs1, vs2)
    def vredsum(self, vd, seed, vs2): self._emit(isa.VREDSUM, vd, seed, vs2)
    def vredmax(self, vd, seed, vs2): self._emit(isa.VREDMAX, vd, seed, vs2)
    def vmv(self, vd, vs1): self._emit(isa.VMVV, vd, vs1)
    def vmslt(self, vs1, vs2): self._emit(isa.VCMPLT, -1, vs1, vs2)
    def vmerge(self, vd, vs1, vs2): self._emit(isa.VMERGE, vd, vs1, vs2)
    def vslide1dn(self, vd, vs1, x=0.0):
        self._emit(isa.VSLIDE1DN, vd, vs1, imm=x)
    def vslide1up(self, vd, vs1, x=0.0):
        self._emit(isa.VSLIDE1UP, vd, vs1, imm=x)
    def vmul_sc(self, vd, vs1, x): self._emit(isa.VMULSC, vd, vs1, imm=x)
    def vadd_sc(self, vd, vs1, x): self._emit(isa.VADDSC, vd, vs1, imm=x)

    def scalar(self, n=1):
        """n cycles of scalar bookkeeping (pointer bumps, vsetvli, branch)."""
        self._emit(isa.SCALAR, cost=int(n))

    # -------------------------------------------------------------- repeat --
    @contextlib.contextmanager
    def repeat(self, n: int):
        """Replicate the enclosed block n times, advancing each memory-op
        address by the head of its per-level stride vector per iteration
        (vectorised expansion).

        Repeats nest to ANY depth: after expansion the stride vector shifts
        down one level (``strides[k+1]`` becomes ``strides[k]``), so each
        enclosing repeat consumes the next level — e.g. an inner loop over K
        with level-0 stride 4, a column-chunk loop at level 1, a row loop at
        level 2, and a batch/head loop at level 3."""
        if n < 1:
            raise ValueError("repeat count must be >= 1")
        start = len(self._cols["op"])
        yield
        k = len(self._cols["op"]) - start
        if k == 0:
            return
        block = {f: np.asarray(self._cols[f][start:], dtype=np.float64
                               if f == "imm" else np.int64)
                 for f in _FIELDS}
        sblock = [np.asarray(col[start:], np.int64) for col in self._strides]
        reps = np.arange(n, dtype=np.int64)
        tiled = {f: np.tile(block[f], n) for f in _FIELDS}
        addr = tiled["addr"].copy()
        mem = addr >= 0
        if sblock:
            stride = np.tile(sblock[0], n)
            addr[mem] = addr[mem] + np.repeat(reps, k)[mem] * stride[mem]
        tiled["addr"] = addr
        for f in _FIELDS:
            del self._cols[f][start:]
            self._cols[f].extend(tiled[f].tolist())
        # Shift the stride vector down one level (level 0 was consumed).
        for lv, col in enumerate(self._strides):
            del col[start:]
            if lv + 1 < len(sblock):
                col.extend(np.tile(sblock[lv + 1], n).tolist())
            else:
                col.extend([0] * (k * n))
        if n >= 2:
            # Tiling replicates any repeat blocks recorded inside this one;
            # replicate their metadata too, then record this block itself.
            inner = [s for s in self._segs if s[0] >= start]
            for r in range(1, n):
                self._segs.extend((s0 + r * k, bl, c) for s0, bl, c in inner)
            self._segs.append((start, k, n))

    # ------------------------------------------------------------ finalize --
    def finalize(self, mm: MemoryMap, extra_bytes: int = 0) -> Program:
        c = self._cols
        return Program(
            op=np.asarray(c["op"], np.int32),
            vd=np.asarray(c["vd"], np.int32),
            vs1=np.asarray(c["vs1"], np.int32),
            vs2=np.asarray(c["vs2"], np.int32),
            addr=np.asarray(c["addr"], np.int64),
            imm=np.asarray(c["imm"], np.float32),
            cost_override=np.asarray(c["cost_override"], np.int32),
            memory=mm.build(extra_bytes),
            buffers=dict(mm.buffers),
            name=self.name,
            repeats=sorted(self._segs),
        )
