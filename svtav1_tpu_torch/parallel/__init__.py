"""Multi-device encode over a list of torch devices (``mesh``)."""
