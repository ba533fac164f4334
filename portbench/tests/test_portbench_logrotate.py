"""The log-rotation cell, found by its name alone."""
from portbench import cells


def test_logrotate_cell_found_by_name():
    """Its own configuration, the ``compress-logs`` traffic, the
    ``compress`` op, the ``logs`` kind, and the BWT's metrics among its
    own."""
    cell = cells.load("logrotate-9.compress-logs")
    assert cell.chips == 1
    assert (cell.config["name"], cell.config["level"],
            cell.config["block_bytes"]) == ("logrotate-9", 9, 900_000)
    assert cell.config["engine"] == {"host_workers": 0}
    assert cell.traffic["op"] == "compress" and cell.traffic["clients"] == 1
    assert cells.op_class(cell.traffic["op"]).op == "compress"
    kind = cells.kind(cell.traffic["data"]["kind"])
    assert cell.traffic["data"]["kind"] == "logs" and kind.TAG == 2
    assert {m["name"] for m in cell.end_to_end} == {
        "compress_MBps", "compress_p95_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"bwt_full_rounds_per_call.compress",
            "bwt_device_ms_per_MiB.compress",
            "bwt_rounds_per_block.compress"} <= names
