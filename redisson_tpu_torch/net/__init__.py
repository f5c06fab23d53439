"""The wire layer.  Only ``resp.RespError`` is here so far; the RESP codec
and the client come with the server slice."""
