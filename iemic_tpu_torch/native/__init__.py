"""Native (host C++) runtime components of the port."""
