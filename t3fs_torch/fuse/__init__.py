"""User-surface file layer: VFS ops bridging MetaClient + StorageClient
(reference: src/fuse/ — FuseOps.cc lowlevel ops, PioV batch gathering).

The port of the library half of t3fs/fuse: FileSystem, FileHandle and
PioV.  The kernel FUSE mount, its ring workers and the user config are not
ported."""

from t3fs_torch.fuse.vfs import FileHandle, FileSystem  # noqa: F401
