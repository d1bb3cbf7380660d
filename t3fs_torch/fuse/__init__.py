"""User-surface file layer: VFS ops bridging MetaClient + StorageClient
(reference: src/fuse/ — FuseOps.cc lowlevel ops, PioV batch gathering).

The port of t3fs/fuse without the kernel mount: FileSystem, FileHandle and
PioV (vfs.py) and the daemon's USRBIO RingWorker (ring_worker.py).  The
kernel FUSE mount and the user config are not ported."""

from t3fs_torch.fuse.vfs import FileHandle, FileSystem  # noqa: F401
