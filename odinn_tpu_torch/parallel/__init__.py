"""Scale-out: the glacier axis over the ranks of a torch.distributed job
(``mesh``), one process per device (``multiprocess``, ``mp_worker``), and
grid rows over a second mesh dimension (``spatial``)."""
