"""Agent-side client: connect, receive the id handshake, stream messages.

The counterpart of the reference's agent `Communicator`
(`orb_slam3/src/comm/communicator.cpp:54-139` and
`CommunicatorBase::ConnectToServer`, `communicator_base.cpp:65-108`), as a
small synchronous socket wrapper usable from any front-end/replay process.
Counterpart of `covins_tpu/comm/client.py`; it speaks the same frames, so
it attaches to a server of either package.
"""

from __future__ import annotations

import json
import socket
from typing import Optional

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.comm import wire


class AgentClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 9871,
                 timeout: float = 30.0, resume_client_id: Optional[int] = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        # server->agent pushed messages (`data_to_client` plane,
        # `communicator_be.cpp:51-69`): keyframe-update messages carrying
        # server-optimized poses, collected while reading replies or via
        # `poll_updates()`
        self.updates: list = []
        # persistent receive buffer: a timeout mid-frame (e.g. the server's
        # periodic `data_to_client` push racing `poll_updates`) must never
        # discard partially-read bytes, or the wire stream desynchronizes
        self._rxbuf = bytearray()
        self.client_id = self._recv_handshake()
        if resume_client_id is not None:
            self.sock.sendall(wire.frame(
                msgs.MSG_HANDSHAKE,
                json.dumps({"resume_client_id": resume_client_id}).encode(),
            ))
            self.client_id = resume_client_id

    def _try_frame(self):
        """Pop one complete frame from the buffer, or None.  Bytes are only
        consumed once the FULL frame is present, so a timeout can never
        split a frame."""
        if len(self._rxbuf) < wire.HEADER_SIZE:
            return None
        msg_type, plen = wire.parse_header(bytes(self._rxbuf[: wire.HEADER_SIZE]))
        total = wire.HEADER_SIZE + plen
        if len(self._rxbuf) < total:
            return None
        payload = bytes(self._rxbuf[wire.HEADER_SIZE : total])
        del self._rxbuf[:total]
        return msg_type, payload

    def _recv_frame(self):
        while True:
            frame = self._try_frame()
            if frame is not None:
                return frame
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed connection")
            self._rxbuf += chunk

    def _recv_handshake(self) -> int:
        msg_type, payload = self._recv_frame()
        assert msg_type == msgs.MSG_HANDSHAKE
        return int(json.loads(payload)["client_id"])

    def _stash(self, msg_type: int, payload: bytes) -> None:
        self.updates.append(wire.decode_message(msg_type, memoryview(payload)))

    def send(self, msg) -> None:
        self.sock.sendall(wire.encode_message(msg))

    def poll_updates(self, timeout: float = 0.0) -> list:
        """Drain any server-pushed messages; returns the accumulated list.

        Partial frames stay in `_rxbuf` across calls (never dropped) and
        the socket's previous timeout is restored afterwards."""
        prev_timeout = self.sock.gettimeout()
        self.sock.settimeout(timeout if timeout > 0 else 0.000001)
        try:
            while True:
                frame = self._try_frame()
                if frame is not None:
                    self._stash(*frame)
                    continue
                chunk = self.sock.recv(65536)
                if not chunk:
                    break  # server closed; keep whatever was drained
                self._rxbuf += chunk
        except (socket.timeout, BlockingIOError):
            pass
        finally:
            self.sock.settimeout(prev_timeout)
        return self.updates

    def admin(self, verb: str, **kw) -> dict:
        from covins_tpu_torch.comm.server import MSG_ADMIN, MSG_ADMIN_REPLY
        cmd = {"verb": verb, **kw}
        self.sock.sendall(wire.frame(MSG_ADMIN, json.dumps(cmd).encode()))
        while True:
            msg_type, payload = self._recv_frame()
            if msg_type == MSG_ADMIN_REPLY:
                return json.loads(payload)
            self._stash(msg_type, payload)  # pushed update in between

    def finish(self):
        try:
            self.sock.sendall(wire.frame(msgs.MSG_FINISH, b""))
        finally:
            self.sock.close()
