"""Native (C++) host components, built with g++ at first use and loaded
with ctypes: `fastpack`, the threaded .npy writer of restarts."""
