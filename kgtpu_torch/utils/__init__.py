"""Host-process utilities of the port."""
