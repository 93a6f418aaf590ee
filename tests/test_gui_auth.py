"""GUI auth logic tests (gan_login_gui.py:300-326 parity)."""

import hashlib
import json

from multi_style_transfer_gan.gui import auth


def test_register_login_roundtrip(tmp_path):
    users = tmp_path / "users.json"
    ok, msg = auth.register_user("bob", "pw123", path=users)
    assert ok
    # duplicate rejected
    ok2, msg2 = auth.register_user("bob", "other", path=users)
    assert not ok2
    assert auth.validate_login("bob", "pw123", path=users)
    assert not auth.validate_login("bob", "wrong", path=users)
    assert not auth.validate_login("nobody", "pw123", path=users)
    # reference-compatible hash format
    stored = json.loads(users.read_text())["bob"]
    assert stored == hashlib.sha256(b"pw123").hexdigest()


def test_empty_credentials_rejected(tmp_path):
    ok, msg = auth.register_user("", "x", path=tmp_path / "u.json")
    assert not ok
    ok, msg = auth.register_user("x", "", path=tmp_path / "u.json")
    assert not ok


def test_remember_me_stores_hash_not_plaintext(tmp_path):
    users = tmp_path / "users.json"
    cred = tmp_path / "cred.json"
    auth.register_user("carol", "hunter2", path=users)
    auth.save_credentials("carol", "hunter2", path=cred)
    data = json.loads(cred.read_text())
    assert "hunter2" not in json.dumps(data)  # no plaintext on disk
    assert auth.load_credentials(path=cred, users_path=users) == "carol"
    # stale credentials (password changed) are rejected
    u = json.loads(users.read_text())
    u["carol"] = auth.hash_password("newpass")
    users.write_text(json.dumps(u))
    assert auth.load_credentials(path=cred, users_path=users) is None
