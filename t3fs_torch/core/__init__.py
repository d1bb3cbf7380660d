"""CoreService: the common RPCs every server registers."""
