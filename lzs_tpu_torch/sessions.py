"""Stateful LZS sessions: one carried history a link, many links a call.

PPP's Stac LZS compression (RFC 1974, History Count 1), LZS-DCP (RFC
1967) and TLS with LZS (RFC 3943) keep one compression history a link
and carry it from packet to packet: each packet is encoded against the
link's last 2047 plaintext bytes and its data ends with an end marker
padded to a byte, so the peer decodes it whole while keeping its own
history (as ``stream.StreamDecompressor`` does across end markers).

``SessionCodec`` keeps every link's history on its device and
compresses one packet a link a call, as one batch through the encode
pipeline of ``ops.encode``:

  history  rows of [history | packet] are assembled with each history's
           first byte at position 0, so nothing before a link's history
           (no padding) is ever a match source; after the encode each
           link's history becomes the last ``min(2047, hlen + n)`` bytes
           of its row (span ``lzs::history``, both halves);
  encode   ``ops.encode.encode_batch`` with ``start = hlen``: the match
           search runs over the whole row, the greedy walk and the
           emission start at the history's end.

The links' packets depend on one another through their history, so a
batch runs across links, never along one link. A CPU device runs every
stage's plain torch version.
"""

from __future__ import annotations

import torch

from . import spec, trace
from .ops import encode

#: bytes of history a link carries: LZS's window
HISTORY = spec.WINDOW_SIZE


class SessionCodec:
    """Compress one packet from each of ``sessions`` links a call, each
    against that link's carried history, on ``device`` (the CUDA card
    unless the caller names another).

    ``hist`` (uint8[S, 2047]) and ``hlen`` (int32[S]) hold the histories
    on the device: row s's first ``hlen[s]`` bytes, zeros after them.
    ``calls``, ``rows_compressed`` and ``rows_reset`` count on the host.
    """

    def __init__(self, sessions: int, *, mtu: int = 1500,
                 device: torch.device | str = "cuda"):
        if sessions < 1:
            raise ValueError(f"sessions {sessions} must be at least 1")
        # the match search takes rows of up to 32768 positions
        if not 1 <= mtu <= (1 << 15) - HISTORY:
            raise ValueError(f"mtu {mtu} outside [1, {(1 << 15) - HISTORY}]")
        self.sessions, self.mtu = sessions, mtu
        self.device = torch.device(device)
        self.cap = encode.cap_bytes(mtu)
        self.hist = torch.zeros((sessions, HISTORY), dtype=torch.uint8,
                                device=self.device)
        self.hlen = torch.zeros(sessions, dtype=torch.int32,
                                device=self.device)
        self.calls = self.rows_compressed = self.rows_reset = 0

    def compress(self, x: torch.Tensor, n: torch.Tensor):
        """(uint8[S, mtu], int32[S]) -> (comp uint8[S, cap_bytes(mtu)],
        nbytes int32[S]).

        Row s's stream is the greedy LZS data of ``x[s, :n[s]]`` against
        link s's history, with one end marker and zero bits to a byte; a
        0-byte packet gives the end marker alone and leaves the history
        as it was. Then each history holds its link's last
        ``min(2047, hlen + n)`` plaintext bytes. ``n`` outside [0, mtu]
        raises ValueError.
        """
        if x.dtype != torch.uint8 or tuple(x.shape) != (self.sessions,
                                                        self.mtu):
            raise ValueError(f"x: expected uint8[{self.sessions}, "
                             f"{self.mtu}], got {x.dtype}"
                             f"{list(x.shape)}")
        if tuple(n.shape) != (self.sessions,):
            raise ValueError(f"n: expected [{self.sessions}], got "
                             f"{list(n.shape)}")
        x = x.to(self.device)
        n = n.to(self.device, torch.int32)
        with trace.host("wait"):
            low, top = torch.aminmax(n)
            low, top = int(low), int(top)
        if low < 0 or top > self.mtu:
            raise ValueError(f"packet lengths {low}..{top} outside "
                             f"[0, {self.mtu}]")
        with trace.stage("history"):
            rows, total = self._rows(x, n)
        comp, nbytes = encode.encode_batch(rows, total, start=self.hlen)
        with trace.stage("history"):
            self._keep_tail(rows, total)
        self.calls += 1
        self.rows_compressed += self.sessions
        return comp[:, :self.cap], nbytes

    def _rows(self, x: torch.Tensor, n: torch.Tensor):
        """(rows uint8[S, 2047 + mtu], lengths int32[S]): each link's
        history, then its packet, then zeros."""
        width = HISTORY + self.mtu
        j = torch.arange(width, device=self.device)[None, :]
        hl = self.hlen[:, None].long()
        total = self.hlen + n
        src = torch.cat([self.hist, x], 1)
        idx = torch.where(j < hl, j, j - hl + HISTORY).clamp_(max=width - 1)
        rows = torch.where(j < total[:, None], src.gather(1, idx), 0)
        return rows.to(torch.uint8), total

    def _keep_tail(self, rows: torch.Tensor, total: torch.Tensor) -> None:
        """Each history becomes the last min(2047, total) bytes of its
        row."""
        keep = total.clamp(max=HISTORY)
        k = torch.arange(HISTORY, device=self.device)[None, :]
        idx = ((total - keep)[:, None].long() + k).clamp_(
            max=rows.shape[1] - 1)
        self.hist.copy_(torch.where(k < keep[:, None], rows.gather(1, idx),
                                    0))
        self.hlen.copy_(keep)

    def reset(self, rows) -> None:
        """Empty the histories of ``rows`` (bool[S], or indices), as for
        new sessions."""
        idx = torch.as_tensor(rows)
        if idx.dtype == torch.bool:
            if tuple(idx.shape) != (self.sessions,):
                raise ValueError(f"rows: a mask must be bool[{self.sessions}]"
                                 f", got {list(idx.shape)}")
            idx = idx.nonzero().flatten()
        idx = idx.to(self.device, torch.long).flatten()
        self.hist[idx] = 0
        self.hlen[idx] = 0
        self.rows_reset += idx.numel()

    def history(self, row: int) -> bytes:
        """Link ``row``'s history: its last plaintext bytes, at most
        2047."""
        return bytes(self.hist[row, :int(self.hlen[row])].cpu().numpy())

    # -- checkpoint / resume --
    def state_dict(self) -> dict:
        """Every history and the counters, copied to the host."""
        return {"sessions": self.sessions, "mtu": self.mtu,
                "hist": self.hist.to("cpu", copy=True),
                "hlen": self.hlen.to("cpu", copy=True),
                "calls": self.calls, "rows_compressed": self.rows_compressed,
                "rows_reset": self.rows_reset}

    def load_state_dict(self, d: dict) -> None:
        """Take the histories and counters of ``state_dict()``."""
        if (d["sessions"], d["mtu"]) != (self.sessions, self.mtu):
            raise ValueError(f"state of {d['sessions']} sessions at mtu "
                             f"{d['mtu']}, codec of {self.sessions} at "
                             f"{self.mtu}")
        hlen = torch.as_tensor(d["hlen"], dtype=torch.int32)
        if int(hlen.min()) < 0 or int(hlen.max()) > HISTORY:
            raise ValueError("history lengths outside [0, 2047]")
        self.hist.copy_(torch.as_tensor(d["hist"], dtype=torch.uint8))
        self.hlen.copy_(hlen)
        self.calls = d["calls"]
        self.rows_compressed = d["rows_compressed"]
        self.rows_reset = d["rows_reset"]
