"""Asyncio RPC fabric (reference: src/common/net/ — SURVEY.md §2.1/§5.8).

Frame = MessageHeader (CRC-checked) + serde MessagePacket + optional raw
payload.  Connections are duplex: either peer can initiate requests, which is
how one-sided RDMA READ/WRITE semantics are emulated over TCP (the storage
server *pulls* write data from a client RemoteBuf and *pushes* read results
back, mirroring StorageOperator.cc:560-591/178-226).
"""

from t3fs_torch.net.wire import MessagePacket, FrameError
from t3fs_torch.net.conn import Connection
from t3fs_torch.net.server import Server, rpc_method, service
from t3fs_torch.net.client import Client
from t3fs_torch.net.rdma import BufferRegistry, RemoteBuf
