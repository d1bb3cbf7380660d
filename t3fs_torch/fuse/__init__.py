"""User-surface file layer: VFS ops bridging MetaClient + StorageClient
(reference: src/fuse/ — FuseOps.cc lowlevel ops, PioV batch gathering).

The port of t3fs/fuse: FileSystem, FileHandle and PioV (vfs.py), the
daemon's USRBIO RingWorker (ring_worker.py), the kernel FUSE mount
(kernel.py, served by app/fuse_main.py) and its per-user config and
/t3fs-virt tree (user_config.py)."""

from t3fs_torch.fuse.vfs import FileHandle, FileSystem  # noqa: F401
