"""The paper's datasets and host-side layout helpers (numpy)."""
