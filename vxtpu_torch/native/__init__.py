"""Host-side native code bound with ctypes (counterpart of
``vxtpu/native``): the asynchronous PNG frame sink."""
