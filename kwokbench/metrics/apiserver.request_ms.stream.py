"""Mean apiserver request time (ms) over the window: the change of
``kwok_apiserver_request_duration_seconds``' sum over the change of its
count, every verb and kind, from the apiserver's ``/metrics``."""


def read(data):
    n = data.get("api_requests")
    return data["api_seconds"] / n * 1e3 if n else None
