"""The EDL1 wire: framing, the request/response client and the threaded server."""
