"""GOP / coding-structure construction.

Frames are placed in three steps: intras at ``intra_pos``, P-frames at
``p_pos`` (referencing the closest past frame), then the gaps are filled with
hierarchical B-frames (recursive midpoint, depth = max(ref depths) + 1).
Coding order is assignment order: all intras, all Ps, then Bs as created.

Reference parity: coolchic/utils/codingstructure.py:158-436.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from coolchic_tpu_torch.io.framedata import FrameData


@dataclass
class Frame:
    coding_order: int
    display_order: int
    frame_offset: int = 0
    depth: int = 0
    seq_name: str = ""
    data: Optional[FrameData] = None
    index_references: List[int] = field(default_factory=list)
    refs_data: List[FrameData] = field(default_factory=list)
    frame_type: str = field(init=False)

    def __post_init__(self):
        if len(self.index_references) > 2:
            raise ValueError("A frame cannot have more than 2 references")
        self.index_references.sort()
        self.frame_type = {0: "I", 1: "P", 2: "B"}[len(self.index_references)]


@dataclass
class CodingStructure:
    n_frames: int
    intra_pos: List[int] = field(default_factory=lambda: [0])
    p_pos: List[int] = field(default_factory=list)
    seq_name: str = ""
    frame_offset: int = 0
    frames: List[Frame] = field(init=False)

    def __post_init__(self):
        self.intra_pos = sorted(dict.fromkeys(self.intra_pos))
        self.p_pos = sorted(dict.fromkeys(self.p_pos))
        if not self.intra_pos or self.intra_pos[0] != 0:
            raise ValueError("First frame of the video must be an intra frame")
        last = self.n_frames - 1
        if self.intra_pos[-1] != last and (not self.p_pos or self.p_pos[-1] != last):
            raise ValueError("Last frame must be an intra or P frame")
        if set(self.intra_pos) & set(self.p_pos):
            raise ValueError("A frame cannot be both I and P")
        self.frames = self._compute()

    def _compute(self) -> List[Frame]:
        frames: List[Frame] = []

        def closest_past(idx: int) -> Frame:
            best = min(frames, key=lambda f: f.display_order)
            for f in sorted(frames, key=lambda f: f.display_order):
                if f.display_order >= idx:
                    break
                best = f
            return best

        def closest_future(idx: int) -> Frame:
            best = max(frames, key=lambda f: f.display_order)
            for f in sorted(frames, key=lambda f: f.display_order, reverse=True):
                if f.display_order <= idx:
                    break
                best = f
            return best

        for pos in self.intra_pos:
            frames.append(Frame(coding_order=len(frames), display_order=pos, depth=0,
                                seq_name=self.seq_name, frame_offset=self.frame_offset))
        for pos in self.p_pos:
            past = closest_past(pos)
            frames.append(Frame(coding_order=len(frames), display_order=pos,
                                index_references=[past.display_order], depth=past.depth + 1,
                                seq_name=self.seq_name, frame_offset=self.frame_offset))
        while len(frames) < self.n_frames:
            placed = {f.display_order for f in frames}
            for i in range(self.n_frames):
                if i in placed:
                    continue
                past = closest_past(i)
                future = closest_future(i)
                mid = past.display_order + (future.display_order - past.display_order) // 2
                frames.append(Frame(
                    coding_order=len(frames), display_order=mid,
                    index_references=[past.display_order, future.display_order],
                    depth=max(past.depth, future.depth) + 1,
                    seq_name=self.seq_name, frame_offset=self.frame_offset))
                break
        return frames

    # ------------------------------------------------------------------
    def get_frame_from_coding_order(self, coding_order: int) -> Optional[Frame]:
        for f in self.frames:
            if f.coding_order == coding_order:
                return f
        return None

    def get_frame_from_display_order(self, display_order: int) -> Optional[Frame]:
        for f in self.frames:
            if f.display_order == display_order:
                return f
        return None

    def get_max_coding_order(self) -> int:
        return max(f.coding_order for f in self.frames)

    def get_max_display_order(self) -> int:
        return max(f.display_order for f in self.frames)

    def pretty_structure_diagram(self) -> str:
        """ASCII GOP diagram: one row per depth, one column per display index."""
        max_depth = max(f.depth for f in self.frames)
        max_disp = self.get_max_display_order()
        lines = []
        for d in range(max_depth + 1):
            row = ""
            for i in range(max_disp + 1):
                f = self.get_frame_from_display_order(i)
                row += f"{f.frame_type}{f.coding_order:<3}" if f is not None and f.depth == d \
                    else "    "
            lines.append(row.rstrip())
        return "\n".join(lines)

    def pretty_string(self) -> str:
        s = f"{'type':>5} {'coding':>7} {'display':>8} {'refs':>12} {'depth':>6}\n"
        for f in sorted(self.frames, key=lambda f: f.coding_order):
            s += (f"{f.frame_type:>5} {f.coding_order:>7} {f.display_order:>8} "
                  f"{str(f.index_references):>12} {f.depth:>6}\n")
        return s
