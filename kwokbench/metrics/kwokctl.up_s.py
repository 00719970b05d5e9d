"""Seconds of ``kwokctl create cluster`` until it returns with every
component up."""


def read(data):
    return data.get("up_s")
