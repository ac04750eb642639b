"""The reference's HTTP detection endpoint and its micro-batching queue."""
