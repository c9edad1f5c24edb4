"""The port's AV1 decoder (``decoder.Decoder``)."""
