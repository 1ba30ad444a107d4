"""The coordination store's wire: framing and the request/response client."""
