"""One runner a kind of traffic: it runs the window and decides ``correct``."""
