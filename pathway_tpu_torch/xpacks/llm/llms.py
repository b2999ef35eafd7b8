"""Chat-model wrappers (reference ``xpacks/llm/llms.py:97-549``).

Remote chats (OpenAI/LiteLLM/Cohere) are async UDFs gated on their client
libraries — with INJECTABLE transports (the connector fake-client pattern):
pass ``client=`` (OpenAI/Cohere-shaped object) or ``acompletion=``
(LiteLLM-shaped coroutine) and the wrapper's request/parse/retry/capacity
plumbing runs without the real library (``tests/test_torch_llm_xpack.py``).
``HFPipelineChat`` runs a local transformers pipeline (on the CPU by
default). All accept the reference's message-dict format and return strings.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF, async_executor
from pathway_tpu_torch.xpacks.llm._utils import require


class BaseChat(UDF):
    """Chat UDF: list-of-message-dicts (or str) → str."""


def _as_messages(value: Any) -> list[dict]:
    if isinstance(value, str):
        return [{"role": "user", "content": value}]
    if hasattr(value, "value"):  # pw.Json
        value = value.value
    return list(value)


class OpenAIChat(BaseChat):
    def __init__(
        self,
        model: str = "gpt-4o-mini",
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        client: Any = None,
        **openai_kwargs,
    ):
        # no `timeout` wrapper param: a timeout= kwarg flows through to the
        # provider API (request-side bound)
        if client is None:
            require("openai", "OpenAIChat")
            import openai

            client = openai.AsyncOpenAI(
                **{k: v for k, v in openai_kwargs.items() if k in ("api_key", "base_url")}
            )
        extra = {k: v for k, v in openai_kwargs.items() if k not in ("api_key", "base_url")}
        self.model = model

        async def chat(messages) -> str:
            r = await client.chat.completions.create(
                model=model, messages=_as_messages(messages), **extra
            )
            return r.choices[0].message.content or ""

        super().__init__(
            _fn=chat,
            return_type=str,
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )


class LiteLLMChat(BaseChat):
    def __init__(
        self,
        model: str,
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        acompletion: Any = None,
        **kwargs,
    ):
        if acompletion is None:
            require("litellm", "LiteLLMChat")
            import litellm

            acompletion = litellm.acompletion
        self.model = model

        async def chat(messages) -> str:
            r = await acompletion(model=model, messages=_as_messages(messages), **kwargs)
            return r.choices[0].message.content or ""

        super().__init__(
            _fn=chat,
            return_type=str,
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )


class CohereChat(BaseChat):
    def __init__(
        self,
        model: str = "command",
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        client: Any = None,
        **kwargs,
    ):
        if client is None:
            require("cohere", "CohereChat")
            import cohere

            client = cohere.AsyncClient()
        self.model = model

        async def chat(messages) -> str:
            msgs = _as_messages(messages)
            r = await client.chat(model=model, message=msgs[-1]["content"], **kwargs)
            return r.text

        super().__init__(
            _fn=chat,
            return_type=str,
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )


class HFPipelineChat(BaseChat):
    """Local transformers text-generation pipeline (reference ``llms.py:447``).
    Runs on the CPU by default; prefer remote or mock chats in the hot path."""

    def __init__(self, model: str, device: str = "cpu", call_kwargs: dict | None = None, **pipeline_kwargs):
        require("transformers", "HFPipelineChat")
        import transformers

        self.pipeline = transformers.pipeline(
            "text-generation", model=model, device=device, **pipeline_kwargs
        )
        pipe = self.pipeline
        ckw = call_kwargs or {}

        def chat(messages) -> str:
            msgs = _as_messages(messages)
            out = pipe(msgs[-1]["content"], **ckw)
            return out[0]["generated_text"]

        super().__init__(_fn=chat, return_type=str)


def prompt_chat_single_qa(question: str) -> Any:
    """Reference helper: wrap a question as a one-message chat (``llms.py``)."""
    import pathway_tpu_torch as pw

    return pw.Json([dict(role="user", content=question)])
