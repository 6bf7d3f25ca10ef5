"""d-gap stream decode: a device-wide prefix sum (``csrc/dgap_decode.cu``)."""
