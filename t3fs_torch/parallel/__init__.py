"""The multi-device data plane of the port: the twin of t3fs/parallel/, on
torch.distributed.  Submodules are imported explicitly; importing this
package loads nothing."""
