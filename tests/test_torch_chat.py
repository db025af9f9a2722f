"""The port's chat sessions (x2i_torch/multiturn.py, x2i_torch/streaming.py)
and the tiny pipeline's ``use_answer`` against the JAX package's on the
CPU: tiny float32 LMs on the same weights (carried across by the bridge),
the same prompts.

The tiny tokenizers of the two packages hash characters differently
(crc32 in the port, Python's ``hash`` in JAX), so the session tests hand
one tokenize function to both. Tolerances as tests/test_torch_decode.py:
1e-4 through the models, token ids, answers and history exactly."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode import TOL, _lm, n
from test_torch_params import one_thread  # noqa: F401 (autouse)
from x2i_tpu import multiturn as jmt
from x2i_tpu import streaming as jst
from x2i_torch import multiturn as tmt
from x2i_torch import streaming as tst
from x2i_torch.models.decoding import greedy_decode_with_hiddens
from x2i_torch.pipeline import build_random_pipeline

VOCAB = 256


def _hash_ids(text, vocab=VOCAB):
    return [zlib.crc32(c.encode()) % vocab for c in text]


def _chat_tokenize(history, user_msg, seq=48):
    text = "".join(f"<u>{h.user}<a>{h.assistant}" for h in history)
    toks = _hash_ids(text + f"<u>{user_msg}<a>")[-seq:]
    ids = np.zeros((1, seq), np.int64)
    ids[0, :len(toks)] = toks
    return ids, np.arange(seq)[None] < len(toks)


def _detok(ids):
    return " ".join(f"t{int(i)}" for i in ids)


def _first_new(tokens):
    """A token of ``tokens`` from the third on that was not emitted
    before it (an EOS that fires mid-answer)."""
    row = [int(x) for x in tokens]
    return next(row[j] for j in range(2, len(row)) if row[j] not in row[:j])


# ------------------------------------------------------------- multi-turn

def _sessions(eos):
    """The JAX and the port's session over one tiny untied LM, the proj
    and the image generator replaced by the identity on the stack."""
    jlm, tree, model = _lm(8, vocab_size=VOCAB, tie_word_embeddings=False)
    ident = dict(max_new_tokens=6, seed=0, eos_token_id=eos)
    want = jmt.MultiTurnSession(
        jlm, tree, _chat_tokenize, _detok, lambda p, h: (h, h), None,
        lambda pooled, emb, seed: emb, **ident)
    got = tmt.MultiTurnSession(
        model, _chat_tokenize, _detok, lambda h: (h, h),
        lambda pooled, emb, seed: emb, **ident)
    return got, want


def test_multiturn_session_matches_jax():
    """Two turns: answers, history and the conditioning (prompt + the
    answer's 6 steps) equal to JAX's, with an EOS inside turn 1's answer
    so that its text stops short of the steps."""
    _, probe = _sessions(-1)
    ids, mask = _chat_tokenize([], "a red fox")
    _, _, tokens, _ = jmt.greedy_decode_with_hiddens(
        probe.lm, probe.lm_params,
        probe.lm.apply(probe.lm_params, jnp.asarray(ids),
                       method=jmt.Qwen2LM.embed),
        jnp.asarray(mask), 6, -1)
    got, want = _sessions(_first_new(np.asarray(tokens)[0]))
    for msg in ("a red fox", "now in the snow"):
        answer, stack = got.turn(msg)
        jans, jstack = want.turn(msg)
        assert answer == jans
        assert tuple(stack.shape) == jstack.shape
        np.testing.assert_allclose(n(stack), n(jstack), **TOL)
    assert got.history == [tmt.ChatTurn(h.user, h.assistant)
                           for h in want.history]
    assert len(got.history[0].assistant.split()) < 6
    got.reset()
    assert got.history == []


def test_random_session_makes_images():
    sess = tmt.build_random_session(seed=0, max_new_tokens=4,
                                    device="cpu")
    for msg in ("a cat", "bigger"):
        answer, image = sess.turn(msg)
        assert image.shape == (1, 64, 64, 3) and image.dtype == np.uint8
        assert 1 <= len(answer.split()) <= 4
    assert [h.user for h in sess.history] == ["a cat", "bigger"]


def test_random_pipeline_serves_use_answer():
    """8 answer tokens after the 32-token prompt: a 40-token stack whose
    prompt part is the plain prefill's; a batch with use_answer goes
    request by request."""
    pipe = build_random_pipeline("tiny", seed=0, device="cpu",
                                 dtype=torch.float32)
    req = {"prompt": "a lighthouse", "use_answer": True}
    stack = pipe.encoder_fn(req)
    plain = pipe.encoder_fn({"prompt": "a lighthouse"})
    assert tuple(stack.shape) == (1, 3, 40, 64)
    torch.testing.assert_close(stack[:, :, :32], plain, **TOL)
    both = pipe.encoder_batch_fn([req, {**req, "prompt": "a bowl"}])
    torch.testing.assert_close(both[:1], stack, rtol=0, atol=0)
    img = pipe.text2image("a lighthouse", use_answer=True)
    assert img.shape == (1, 64, 64, 3)
    assert pipe._random_ctx["lm"].cfg.vocab_size == 512


# -------------------------------------------------------------- streaming

def _toks(s):
    return [ord(c) % 200 for c in s]


def _stream_pair(terminators, max_len=96):
    jlm, tree, model = _lm(9, vocab_size=VOCAB, tie_word_embeddings=False)
    want = jst.make_qwen2_session(jlm, tree, _toks, _detok, max_len=max_len,
                                  terminators=terminators, jit=False)
    got = tst.make_qwen2_session(model, _toks, _detok, max_len=max_len,
                                 terminators=terminators)
    return got, want, model


def _chunks(sess):
    return [sess.prefill("s1", "user", "hello "),
            sess.prefill("s1", "user", "streaming "),
            sess.prefill("s1", "user", "world")]


def test_session_role_bookkeeping():
    """The reference's role strings: im_start on a new user turn, tts_eos
    when the generation was interrupted; a new session id resets."""
    sess, _, _ = _stream_pair([], max_len=256)
    assert sess.prefill("s2", "user", "first chunk") == "first chunk"
    sess.state.new_user_msg = True
    sess.state.llm_generated = True
    sess.state.llm_generate_completed = True
    assert sess.prefill("s2", "user", "next turn").startswith(
        "<|im_end|>\n<|im_start|>user\n")
    sess.state.new_user_msg = True
    sess.state.llm_generate_completed = False
    assert sess.prefill("s2", "user", "barge-in").startswith("<|tts_eos|>")
    sess.prefill("s2", "assistant", "ok")
    assert sess.state.new_user_msg
    assert sess.prefill("s3", "user", "fresh") == "fresh"
    assert sess.state.session_id == "s3" and sess.state.length == 5


def test_streaming_session_matches_one_shot_and_jax():
    """Three chunks, then a reply up to a terminator that the reply
    reaches: the same ids, text and final-layer states as JAX's session,
    and the ids of one prefill_cached + decode_step run over the text
    the session consumed."""
    probe, _, _ = _stream_pair([])
    _chunks(probe)
    ids = probe.generate(max_new_tokens=8, assistant_prompt="")[1]
    term = [_first_new(ids)]
    got, want, model = _stream_pair(term)
    consumed = _chunks(got)
    assert consumed == _chunks(want)
    text, ids, hidden = got.generate(max_new_tokens=8, assistant_prompt="")
    jtext, jids, jhidden = want.generate(max_new_tokens=8,
                                         assistant_prompt="")
    assert ids == jids and text == jtext and 2 <= len(ids) < 8
    assert got.state.llm_generate_completed
    assert tuple(hidden.shape) == jhidden.shape == (1, len(ids), 64)
    np.testing.assert_allclose(n(hidden), n(jhidden), **TOL)
    assert got.state.length == want.state.length

    # one shot over the same text, the port's own cache methods
    full = torch.tensor([_toks("".join(consumed))])
    with torch.inference_mode():
        emb = model.embed(full)
    cache = model.init_cache(1, 96)
    _, logits, cache = model.prefill_cached(emb, torch.ones_like(full).bool(),
                                            cache)
    nxt, idx, one_shot = int(logits[0, -1].argmax()), full.shape[1], []
    slots = torch.arange(96)[None]
    while nxt not in term:
        one_shot.append(nxt)
        with torch.inference_mode():
            e = model.embed(torch.tensor([[nxt]]))
        _, lg, cache = model.decode_step(e, cache, idx, slots <= idx,
                                         torch.full((1, 1), idx))
        nxt, idx = int(lg[0, -1].argmax()), idx + 1
    assert ids == one_shot


def test_streaming_generate_needs_a_prefill():
    sess, _, _ = _stream_pair([])
    with pytest.raises(ValueError, match="prefill first"):
        sess.generate()


def test_greedy_decode_keeps_the_host_out_of_the_loop(monkeypatch):
    """No step reads a device value back to the host: tensor.item and
    int() of a tensor are never called inside the loop."""
    _, _, model = _lm(10)
    calls = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append("item"))
    monkeypatch.setattr(torch.Tensor, "__int__",
                        lambda self: calls.append("int"))
    emb = torch.randn(1, 5, 64)
    out = greedy_decode_with_hiddens(model, emb, torch.ones(1, 5).bool(),
                                     4, 3)
    assert calls == [] and tuple(out[1].shape) == (1, 3, 4, 64)
