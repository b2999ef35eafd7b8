"""The port's Slack writer and the health plane's Slack sink
(``pathway_tpu_torch/io/slack.py``, ``observability/alerts.SlackSink``)
against the JAX package's, mirroring the Slack cases of
``tests/test_health_plane.py``: the sink formats through ``post_message``,
``send_alerts`` posts one message per positive diff through an injected
transport (retractions post nothing), the sinks configured from the
environment, and ``post_message`` without a transport sending the
reference's request (the reference with ``requests``, the port with
``urllib``).
"""

from __future__ import annotations

import importlib

from torch_connector_helpers import PACKAGES, same


def _alerts(pw):
    return importlib.import_module(f"{pw.__name__}.observability.alerts")


def test_slack_sink_formats_through_post_message(monkeypatch):
    def scenario(pw):
        slack_io = importlib.import_module(f"{pw.__name__}.io.slack")
        posted = []
        monkeypatch.setattr(slack_io, "post_message",
                            lambda channel, token, text, transport=None: posted.append((channel, token, text)))
        sink = _alerts(pw).SlackSink("C042", "xoxb-test")
        sent = sink.notify({"alert": "slo_latency_burn", "fingerprint": "/v1/retrieve",
                            "severity": "page", "summary": "burn 16.7"})
        again = sink.notify({"alert": "slo_latency_burn", "fingerprint": "/v1/retrieve"})  # deduplicated
        return sent, again, posted, sink.counters()

    sent, again, posted, counters = same(scenario)
    assert (sent, again) == (True, False)
    assert posted == [("C042", "xoxb-test", ":rotating_light: [page] slo_latency_burn (/v1/retrieve): burn 16.7")]
    assert counters["sent"] == 1


def test_send_alerts_fake_transport():
    """One chat.postMessage per positive diff, through the injected
    transport; a retraction posts nothing."""

    def scenario(pw):
        sent = []
        t = pw.debug.table_from_rows(
            pw.schema_from_types(msg=str),
            [("backlog growing", 0, 1), ("disk full", 0, 1), ("disk full", 2, -1), ("recovered", 2, 1)],
            is_stream=True,
        )
        pw.io.slack.send_alerts(t, "C0HEALTH", "xoxb-42",
                                _transport=lambda url, headers, body: sent.append((url, headers, body)))
        pw.run(monitoring_level="none")
        return sent

    sent = same(scenario)
    assert len(sent) == 3
    for url, headers, body in sent:
        assert url == "https://slack.com/api/chat.postMessage"
        assert headers == {"Authorization": "Bearer xoxb-42"} and body["channel"] == "C0HEALTH"
    assert sorted(b["text"] for _u, _h, b in sent) == ["backlog growing", "disk full", "recovered"]


def test_webhook_and_slack_sinks_from_env(monkeypatch):
    def scenario(pw):
        monkeypatch.setenv("PATHWAY_ALERT_WEBHOOK", "http://127.0.0.1:1/hook")
        monkeypatch.setenv("PATHWAY_ALERT_SLACK_CHANNEL", "C01")
        monkeypatch.setenv("PATHWAY_ALERT_SLACK_TOKEN", "tok")
        cfg = importlib.import_module(f"{pw.__name__}.internals.config").get_pathway_config()
        alerts = _alerts(pw)
        sinks = alerts.AlertRegistry.sinks_from_env(cfg)
        got = ([s.name for s in sinks], sinks[0].url, (sinks[1].channel, sinks[1].token))
        monkeypatch.delenv("PATHWAY_ALERT_WEBHOOK")
        monkeypatch.delenv("PATHWAY_ALERT_SLACK_TOKEN")
        return got, alerts.AlertRegistry.sinks_from_env(cfg)

    got, rest = same(scenario)
    assert got == (["webhook", "slack"], "http://127.0.0.1:1/hook", ("C01", "tok")) and rest == []


def test_post_message_without_a_transport_sends_the_reference_request(monkeypatch):
    """Without a transport the reference posts with ``requests`` and the
    port with ``urllib`` (it carries no HTTP client package): the same POST
    to chat.postMessage, the same bearer token and the same JSON body. Both
    calls are captured here, before any network."""
    import json
    import urllib.request

    import requests

    sent = {}
    monkeypatch.setattr(requests, "post", lambda url, headers=None, json=None: sent.__setitem__(
        "ref", ("POST", url, headers["Authorization"], json)))

    class Done:
        def close(self):
            pass

    def urlopen(req, timeout=None):
        sent["port"] = (req.get_method(), req.full_url, req.get_header("Authorization"), json.loads(req.data))
        assert req.get_header("Content-type") == "application/json"
        return Done()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for pw in PACKAGES:
        importlib.import_module(f"{pw.__name__}.io.slack").post_message("C1", "xoxb-9", "hello")
    assert sent["port"] == sent["ref"] == (
        "POST", "https://slack.com/api/chat.postMessage", "Bearer xoxb-9", {"channel": "C1", "text": "hello"})
